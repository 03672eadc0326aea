"""Run one cell of BENCHMARK.json once and print one JSON line:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with the cards the cell asks for.
With --trace 0 the line carries the cell's end-to-end metrics, with
--trace 1 its per-layer metrics. Exits non-zero, printing no result,
without CUDA or enough cards, without the program, or if JAX or `gea`
was loaded.
"""

import os
import sys

if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    # The script's folder holds no top-level module: only the checkout's
    # root goes on the path.
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, os.path.dirname(here))
    from portbench.harness import main

    sys.exit(main(sys.argv[1:]))
