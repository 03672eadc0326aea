"""The benchmark of `gea_torch`, the PyTorch and CUDA port of `gea`.

`python portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once and prints one JSON line. Everything
that belongs to one configuration, traffic mix or per-layer metric is a file
of its own, found by name:

* `configs/<config>.json`: the configuration's flags, source and cuts;
* `mixes/<traffic>.json`: the parameters of a traffic mix, read by the loop
  it names (`loops/<loop>.py`, one general loop per kind of work);
* `metrics/<metric>.py`: one reader per per-layer metric;
* `limits/<workload>.json`: the limits of the cell's correctness check.

`cost/` holds the yardstick (peaks, FLOP counts, kernel bounds) and
`reference/` the plain PyTorch reference that decides `correct`. Neither
imports `gea_torch`.
"""
