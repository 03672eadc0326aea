"""`tools/readings.py` for a cell of the `riter` loop, whose faults are
`portbench.faults_riter`'s, on the card, at the cell's own sizes, in one
process:

    python3 portbench/tools/readings_riter.py --workload riter80-train \
        --seeds 11,12,13 --control-seeds 21,22,23 --fault-seeds 31,32,33

Prints one JSON line per reading, as `readings.py` does: the program's
numbers on each seed, the control's (the reference in fp8 in the
program's place) and each planted fault's. The benchmark's own runs never
run this.
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from portbench import faults_riter, harness  # noqa: E402

readings = harness.load_file_module(os.path.join(HERE, "readings.py"), "portbench_readings")
readings.faults = faults_riter

if __name__ == "__main__":
    sys.exit(readings.main())
