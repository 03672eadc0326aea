"""Configuration of the PyTorch port: the fields of `gea/config.py`
`ModelConfig` that the generator and discriminator read, the fields of
`TrainGLISConfig` that the G-LIS train step reads, `stage_weights`, and
device resolution for the port's entry points."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

NORM_CHOICES = ("weight", "batch", "none")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class ModelConfig:
    image_size: int = 80
    code_size: int = 256
    norm: str = "weight"
    r_iterations: int = 3
    num_features: int = 64
    max_features: int = 512
    lis_hidden_mult: int = 1
    spatial_code: int = 0
    include_initial_image: bool = True
    dtype: str = "bfloat16"

    def __post_init__(self) -> None:
        if self.norm not in NORM_CHOICES:
            raise ValueError(f"norm must be one of {NORM_CHOICES}, got {self.norm!r}")
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {tuple(DTYPES)}, got {self.dtype!r}")

    @property
    def n_stages(self) -> int:
        if self.r_iterations == 0:
            return 1
        return self.r_iterations + (1 if self.include_initial_image else 0)

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


@dataclass(frozen=True)
class TrainGLISConfig(ModelConfig):
    """The fields of `gea/config.py` `TrainGLISConfig` that the G-LIS train
    step reads, with `gea`'s defaults."""

    batch_size: int = 64
    lr: float = 0.0002
    lr_schedule: str = "constant"  # constant | cosine | linear, over niter updates
    lr_final: float = 0.0  # final lr as a fraction of lr
    beta1: float = 0.5
    beta2: float = 0.999
    niter: int = 50_000
    stage_weight_initial: float = 0.2
    gan_loss: str = "bce"  # bce | hinge | wgan-gp
    gp_weight: float = 10.0
    g_ema: float = 0.0
    grad_accum: int = 1
    remat: bool = False
    seed: int = 42

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.lr_schedule not in ("constant", "cosine", "linear"):
            raise ValueError(f"unknown lr_schedule {self.lr_schedule!r}")
        if self.gan_loss not in ("bce", "hinge", "wgan-gp"):
            raise ValueError(f"unknown gan_loss {self.gan_loss!r}")


def stage_weights(cfg: ModelConfig) -> Tuple[float, ...]:
    """Per-stage adversarial loss weights, final stage highest, normalised to
    sum to 1 (`gea/config.py::stage_weights`)."""
    n = cfg.n_stages
    if n == 1:
        return (1.0,)
    initial = getattr(cfg, "stage_weight_initial", 0.2)
    raw = [initial + (1.0 - initial) * i / (n - 1) for i in range(n)]
    total = sum(raw)
    return tuple(w / total for w in raw)


# The flagship workload of `benchmarks/common.py`: G-LIS-3 at 80x80,
# weight norm, nf 64 / cap 512, bf16 compute with fp32 params.
FLAGSHIP = ModelConfig(
    image_size=80,
    code_size=256,
    norm="weight",
    r_iterations=3,
    num_features=64,
    max_features=512,
    dtype="bfloat16",
)


def generator_plan(image_size: int) -> Tuple[int, int]:
    """(base_resolution, num_doublings) for a target image size:
    80 -> (5, 4); 64 -> (4, 4); 160 -> (5, 5); 32 -> (4, 3)."""
    s, d = image_size, 0
    while s % 2 == 0 and s // 2 >= 4:
        s //= 2
        d += 1
    if s * (2**d) != image_size or d == 0:
        raise ValueError(f"unsupported image_size {image_size}")
    return s, d


def resolve_device(device: Optional[str | torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on. CUDA unless the caller asks for
    the CPU; a CUDA request on a host without CUDA raises."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to run "
            "the port's plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
