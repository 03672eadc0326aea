"""The port's kernels, one module each, with their plain PyTorch versions:

* `tprelu` (Triton)   replaces `gea/ops/pallas/tprelu.py::fused_tprelu`, with
  its backward `fused_tprelu_backward` (`_bwd` there) as a second kernel;
* `lis`    (CUDA C++) replaces `gea/ops/pallas/lis.py::lis_residual_mlp`,
  with its backward `lis_residual_mlp_backward` (`_bwd` there) as a second
  kernel (`csrc/lis_bwd.cu`);
* `seed`   (CUDA C++) replaces `gea/ops/pallas/seed.py::fused_seed`, with
  its backward `fused_seed_backward` (`_bwd` there) as a second set of
  kernels (`csrc/seed_bwd.cu`).

Nothing here builds or imports a GPU toolchain at import time.

Each wrapper counts its launches in `<wrapper>.launches`, in Python, where
it launches its kernel. A CUDA graph runs no Python at replay, so the
dispatcher (`gea_torch.train.dispatch`) takes the counts of a capture out
again and adds them back at every replay (`add_launch_counts`): the counts
are those of the kernels that ran.
"""

from gea_torch.ops.lis import (  # noqa: F401
    lis_residual_mlp,
    lis_residual_mlp_backward,
    lis_residual_mlp_backward_plain,
    lis_residual_mlp_plain,
)
from gea_torch.ops.seed import (  # noqa: F401
    fused_seed,
    fused_seed_backward,
    fused_seed_backward_plain,
    fused_seed_plain,
)
from gea_torch.ops.tprelu import (  # noqa: F401
    fused_tprelu,
    fused_tprelu_backward,
    fused_tprelu_backward_plain,
    fused_tprelu_plain,
)

KERNELS = (fused_tprelu, fused_tprelu_backward, lis_residual_mlp, lis_residual_mlp_backward,
           fused_seed, fused_seed_backward)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def add_launch_counts(counts: dict) -> None:
    """Add {wrapper name: launches} to the counts (negative to take off)."""
    for k in KERNELS:
        k.launches += counts.get(k.__name__, 0)
