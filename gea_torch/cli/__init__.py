"""Command-line entry points of the port (`gea/cli/` is the reference)."""
