"""Median, quartiles and spread of each metric over sets of runs:

    python3 portbench/tools/spread.py SET1_FILES... -- SET2_FILES...

Each file holds a run's output; its last line is the result. A spread is
(Q3 - Q1) / median, the quartiles as `statistics.quantiles(values, n=4)`
gives them. Prints per set and metric: n, median, Q1, Q3, spread, and,
with two sets, the wider spread and 5x it (the bound it suggests), and
the second set's median against the first's. Also the check numbers'
largest value over every run.
"""

from __future__ import annotations

import json
import statistics
import sys
from typing import Dict, List


def last_result(path: str) -> Dict:
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    return json.loads(lines[-1])


def spread(values: List[float]) -> Dict[str, float]:
    q1, med, q3 = statistics.quantiles(values, n=4)
    return {"n": len(values), "median": statistics.median(values), "q1": q1, "q3": q3,
            "spread": (q3 - q1) / statistics.median(values)}


def main(argv: List[str]) -> int:
    sets = [s.split() for s in " ".join(argv).split(" -- ")]
    results = [[last_result(p) for p in files] for files in sets]
    names = sorted({m for rs in results for r in rs for m in r["metrics"]})
    for name in names:
        values = [[r["metrics"][name]["value"] for r in rs if name in r["metrics"]]
                  for rs in results]
        rows = [spread(v) for v in values if len(v) >= 2]
        for i, row in enumerate(rows):
            print(f"{name} set {i + 1}: " + " ".join(f"{k} {v:.6g}" for k, v in row.items()))
        if len(rows) == 2:
            wide = max(r["spread"] for r in rows)
            print(f"{name}: wider spread {wide:.6g}, 5x {5 * wide:.6g}, set 2 / set 1 median "
                  f"{rows[1]['median'] / rows[0]['median']:.6g}")
    worst: Dict[str, float] = {}
    for rs in results:
        for r in rs:
            for k, v in r.get("check", {}).items():
                worst[k] = max(worst.get(k, 0.0), v["value"])
    print("check, largest over the runs:", json.dumps(worst))
    print("correct in every run:", all(r["correct"] for rs in results for r in rs))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
