"""Checkpoints, sample grids, loss plots, the throughput meter and the
host-memory guard (`gea/utils/` is the reference)."""
