"""Loss curves (port of `gea/utils/plotting.py`): per-iteration losses
rendered to a PNG with matplotlib's Agg backend, imported only when a plot
is drawn. Without matplotlib, `plot` says so once and writes nothing."""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List


class LossPlotter:
    def __init__(self) -> None:
        self.steps: List[int] = []
        self.series: Dict[str, List[float]] = defaultdict(list)
        self._warned = False

    def add(self, step: int, **values: float) -> None:
        self.steps.append(step)
        for k, v in values.items():
            self.series[k].append(float(v))

    def plot(self, path: str, ylabel: str = "loss") -> None:
        try:
            import matplotlib
        except ImportError:
            if not self._warned:
                print(f"[gea_torch] matplotlib is not installed: no loss plot at {path}",
                      flush=True)
                self._warned = True
            return
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fig, ax = plt.subplots(figsize=(10, 5))
        for name, values in sorted(self.series.items()):
            ax.plot(self.steps[:len(values)], values, label=name, linewidth=0.9)
        ax.set_xlabel("iteration")
        ax.set_ylabel(ylabel)
        ax.legend(loc="upper right")
        ax.grid(True, alpha=0.3)
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)
