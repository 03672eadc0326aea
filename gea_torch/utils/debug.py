"""The NaN/Inf sanitizer of the train step, `--debug_checks` (port of
`gea/utils/debug.py`).

`gea` instruments its jitted step with checkify's float checks and raises
at the first op that made a NaN. The port runs its step eagerly, so it
checks as the step goes: `FloatChecks` is a `TorchDispatchMode` that sees
every ATen op of the step (the forward, autograd's backward, the optimizer
update and the port kernels' custom ops) and, for each floating tensor the
op writes, appends `isfinite(t).all()` to a list of 0-d flags on the device
and a label to a list on the host: the op, and where it ran (the module
path, from forward hooks on the state's modules; in the backward, the
autograd node). Nothing waits for the device per op: `check` stacks the
flags once a step and raises `FloatingPointError` naming the first op whose
output was not finite.

`checked_step` runs a train step under the checks. `gea_torch.train.
dispatch` drives it once per step, K times per chunk with
`--steps_per_dispatch` K, as `gea` drives its checked single step, so that
the error names the step within the chunk. A debugging mode: the checks
cost two small launches per floating output, several times the step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten
# Ops whose output is uninitialised memory, not a result.
UNINITIALISED = {aten.empty.memory_format, aten.empty_like.default, aten.empty_strided.default,
                 aten.new_empty.default, aten.new_empty_strided.default}


class FloatChecks(TorchDispatchMode):
    """Records a finiteness flag for every floating tensor an op writes,
    while active; `modules` ({prefix: module}) name the forward's ops."""

    def __init__(self, modules: Dict[str, torch.nn.Module]):
        super().__init__()
        self.flags: List[torch.Tensor] = []
        self.labels: List[str] = []
        self._path: List[str] = []
        self._modules = modules
        self._hooks: list = []

    def __enter__(self):
        for prefix, root in self._modules.items():
            for name, m in root.named_modules(prefix=prefix):
                self._hooks.append(m.register_forward_pre_hook(
                    lambda *_, name=name: self._path.append(name)))
                self._hooks.append(m.register_forward_hook(self._leave))
        return super().__enter__()

    def _leave(self, *_) -> None:
        """Forward hook: a hook that returned a value would replace the
        module's output."""
        self._path.pop()

    def __exit__(self, *exc):
        for h in self._hooks:
            h.remove()
        self._hooks.clear()
        self._path.clear()
        return super().__exit__(*exc)

    def _where(self) -> str:
        if self._path:
            return f"in {self._path[-1]}"
        node = getattr(torch._C, "_current_autograd_node", lambda: None)()
        if node is not None:
            return f"in the backward, at {node.name()}"
        return "outside the modules (a loss or the optimizer update)"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in UNINITIALISED or func.is_view:
            return out
        written = tree_leaves(out)
        for i, a in enumerate(func._schema.arguments):  # what in-place ops write
            if a.alias_info is not None and a.alias_info.is_write:
                written += tree_leaves(kwargs[a.name] if a.name in kwargs else
                                       args[i] if i < len(args) else None)
        seen = set()
        for t in written:
            if (isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel()
                    and id(t) not in seen):
                seen.add(id(t))
                self.flags.append(torch.isfinite(t).all())
                self.labels.append(f"{func} {self._where()}")
        return out

    def check(self, where: str) -> None:
        """Raise FloatingPointError at the first op whose output held a
        NaN or Inf (one wait for the device)."""
        if not self.flags:
            return
        bad = (~torch.stack(self.flags)).nonzero()
        if bad.numel():
            first = int(bad[0, 0])
            raise FloatingPointError(
                f"--debug_checks: non-finite output of {self.labels[first]} at {where} "
                f"(op {first + 1} of {len(self.labels)} checked)")


def trained_modules(state) -> Dict[str, torch.nn.Module]:
    """The modules a train state runs, by attribute name."""
    names = ("generator", "discriminator", "reverter")
    return {n: getattr(state, n) for n in names if getattr(state, n, None) is not None}


def checked_step(step: Callable[..., Any]) -> Callable[..., Any]:
    """`step(state, real, **noise)` under `FloatChecks`; the wrapped step
    takes `where=` (what the error names: the iteration, the step within
    the chunk)."""

    def run(state, real, where: str, **noise):
        checks = FloatChecks(trained_modules(state))
        with checks:
            out = step(state, real, **noise)
        checks.check(where)
        return out

    return run

