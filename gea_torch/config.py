"""Configuration of the PyTorch port (a copy of `gea/config.py`'s
`BaseConfig`, `ModelConfig`, `DataConfig`, `TrainGLISConfig`, the
samplers' `SampleConfig` and `SampleInterpolationsConfig`, and the
reverser trainers' `TrainRConfig`, `TrainRSeparateConfig` and
`TrainRIterativeConfig`, with `gea`'s flag names, defaults and choices),
`stage_weights`, the one flag the port does not implement, and device
resolution for the port's entry points."""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple, Type, TypeVar

import torch

T = TypeVar("T", bound="BaseConfig")

NORM_CHOICES = ("weight", "batch", "none")
DATASET_CHOICES = ("folder", "lsun", "synthetic", "cifar10")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _flag(default: Any, help: str, **kw: Any) -> Any:  # noqa: A002
    return field(default=default, metadata={"help": help, **kw})


@dataclass(frozen=True)
class BaseConfig:
    """argparse round trip from the dataclass fields, and JSON round trip
    into the run directory (`config.json`)."""

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls: Type[T], path: str) -> T:
        with open(path) as f:
            return cls.load_dict(json.load(f))

    @classmethod
    def load_dict(cls: Type[T], raw: dict) -> T:
        """The config of a parsed config.json; keys that are no field of
        `cls` are dropped."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in names})

    def replace(self: T, **kw: Any) -> T:
        return dataclasses.replace(self, **kw)

    @classmethod
    def add_args(cls, parser: argparse.ArgumentParser) -> None:
        for f in dataclasses.fields(cls):
            name = "--" + f.name
            help_text = f.metadata.get("help", "") + f" (default: {f.default})"
            if f.type in ("bool", bool):
                parser.add_argument(name, type=_str2bool, nargs="?", const=True,
                                    default=f.default, help=help_text)
            else:
                typ = {"int": int, "float": float, "str": str}.get(str(f.type))
                if typ is None:
                    typ = type(f.default) if f.default is not None else str
                parser.add_argument(name, type=typ, default=f.default,
                                    choices=f.metadata.get("choices"), help=help_text)

    @classmethod
    def from_args(cls: Type[T], argv: Optional[list] = None) -> T:
        parser = argparse.ArgumentParser(description=cls.__doc__)
        cls.add_args(parser)
        ns = parser.parse_args(argv)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in vars(ns).items() if k in names})


def _str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


@dataclass(frozen=True)
class ModelConfig(BaseConfig):
    """Architecture hyper-parameters of G and D."""

    image_size: int = _flag(80, "output image resolution (square)")
    code_size: int = _flag(256, "dimensionality of the noise/code vector z")
    norm: str = _flag("weight", "normalization scheme for G and D", choices=NORM_CHOICES)
    r_iterations: int = _flag(
        3, "number of chained LIS noise-refinement modules in the generator")
    num_features: int = _flag(64, "base channel count of the conv stacks (doubled per halving)")
    max_features: int = _flag(512, "channel cap for the deepest conv layers")
    lis_hidden_mult: int = _flag(
        1, "hidden width of each LIS residual MLP, as a multiple of code_size")
    spatial_code: int = _flag(
        0, "number of spatially-injected noise channels concatenated into an "
        "intermediate generator feature map")
    include_initial_image: bool = _flag(
        True, "also render (and train on) the image for the raw z before any LIS module")
    dtype: str = _flag("bfloat16", "compute dtype (params stay float32)")

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
class DataConfig(BaseConfig):
    """Input pipeline: CenterCrop(crop_size) -> Resize(image_size) ->
    RandomHorizontalFlip -> Normalize to [-1, 1]."""

    dataset: str = _flag("folder", "dataset kind", choices=DATASET_CHOICES)
    dataroot: str = _flag("", "path to the image folder (CelebA dump)")
    lsun_classes: str = _flag("bedroom", "comma-separated LSUN class names (dataset=lsun)")
    crop_size: int = _flag(160, "center-crop size applied before resize")
    batch_size: int = _flag(64, "global batch size")
    data_workers: int = _flag(4, "host-side decode worker threads")
    data_backend: str = _flag(
        "auto", "image decode backend: native C++ pool (JPEG), PIL threads, grain "
        "(MapDataset pipeline), or auto (native when it builds and the folder is "
        "all-JPEG, else PIL)",
        choices=("auto", "native", "pil", "grain"))
    data_cache: bool = _flag(
        False, "decode the whole folder once into host RAM (uint8) and serve "
        "batches from memory")
    device_data_cache: bool = _flag(
        False, "place the whole decoded dataset in device memory once and gather "
        "batches on the device: each step sends only the batch's indices")
    on_device_pipeline: bool = _flag(
        True, "crop/resize/flip/normalize on the device instead of on the host; "
        "the host only decodes to uint8")
    host_resize: bool = _flag(
        False, "crop and downsample to image_size on the host and stream uint8 at "
        "the final resolution; flip/normalize stay on the device")
    synthetic_on_device: bool = _flag(
        False, "dataset=synthetic only: generate the synthetic batch on the device "
        "(no host->device input transfer)")
    augment_flip: bool = _flag(True, "random horizontal flip augmentation")


@dataclass(frozen=True)
class TrainGLISConfig(ModelConfig, DataConfig):
    """Alternating G/D training of the G-LIS generator (`gea.cli.train_glis`)."""

    lr: float = _flag(0.0002, "Adam learning rate for G and D")
    lr_schedule: str = _flag(
        "constant", "learning-rate schedule over --niter steps: cosine or linear decay "
        "from --lr to --lr_final * --lr", choices=("constant", "cosine", "linear"))
    lr_final: float = _flag(0.0, "final learning rate as a FRACTION of --lr")
    beta1: float = _flag(0.5, "Adam beta1 (DCGAN convention)")
    beta2: float = _flag(0.999, "Adam beta2")
    niter: int = _flag(50_000, "number of training iterations")
    stage_weight_initial: float = _flag(
        0.2, "relative adversarial-loss weight of non-final LIS stages; the final "
        "stage always has weight 1.0 before normalization")
    fid_interval: int = _flag(
        0, "compute proxy-FID of the final LIS stage against the training data every N "
        "steps, log to <run>/fid.jsonl, and keep the best-scoring checkpoint pinned "
        "(best.json; load it anywhere with --step -1). 0 disables")
    fid_samples: int = _flag(1024, "sample count per --fid_interval evaluation (real and fake)")
    gan_loss: str = _flag(
        "bce", "GAN objective: BCE, hinge, or WGAN with gradient penalty",
        choices=("bce", "hinge", "wgan-gp"))
    gp_weight: float = _flag(10.0, "gradient-penalty weight for --gan_loss wgan-gp")
    stop_patience: int = _flag(
        0, "early stopping: end the run after this many consecutive --fid_interval "
        "evaluations without a new best FID (the best snapshot stays pinned for --step -1). "
        "0 disables; requires --fid_interval > 0")
    g_ema: float = _flag(
        0.0, "decay for an exponential moving average of G's params; 0 disables")
    seed: int = _flag(42, "PRNG seed")
    save_path: str = _flag("runs/glis", "experiment directory for outputs")
    load_path: str = _flag("", "resume from this experiment directory")
    save_interval: int = _flag(2000, "checkpoint every N iterations")
    keep_checkpoints: int = _flag(0, "retain only the newest K checkpoints (0 = keep all)")
    max_host_rss_gb: float = _flag(
        0.0, "host-RSS budget: checkpoint + exit 19 (for auto-resume) when the process "
        "exceeds it. 0 = auto (85%% of system RAM), negative disables")
    vis_interval: int = _flag(500, "sample grid + loss plot every N iters")
    vis_rows: int = _flag(8, "rows (and cols) of the sample grid")
    log_interval: int = _flag(50, "stdout loss print every N iterations")
    num_devices: int = _flag(
        0, "data-parallel device count; 0 = all visible devices (one process on the CPU)")
    model_shards: int = _flag(
        1, "tensor parallelism: shard wide output-channel axes over a 'model' axis of "
        "this size (must divide the device count; the rest is the 'data' axis). 1 = "
        "pure data parallel. Single-host")
    tp_min_width: int = _flag(
        64, "model_shards > 1: only shard state leaves whose last axis is at least this "
        "wide (narrow leaves replicate)")
    steps_per_dispatch: int = _flag(
        1, "fuse K train steps into one dispatch (one CUDA graph replay on the card) - "
        "amortizes the host's per-launch cost; log/vis/save cadences fire at chunk "
        "boundaries. 1 = one eager step per iteration")
    grad_accum: int = _flag(
        1, "accumulate gradients over K sequential microbatches per optimizer update")
    remat: bool = _flag(False, "recompute the generator forward in its backward")
    profile_dir: str = _flag(
        "", "if set, write a torch.profiler trace for steps 10..15 here")
    use_pallas: bool = _flag(
        False, "moot in the port: its kernels always run on the card")
    tensorboard: bool = _flag(
        False, "also write scalars to <save_path>/tb via torch.utils.tensorboard")
    multihost: bool = _flag(
        False, "join the process group of a multi-host launch at startup (one process a "
        "card; requires torchrun's RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT or "
        "GEA_COORDINATOR/GEA_NUM_PROCESSES/GEA_PROCESS_ID)")
    debug_checks: bool = _flag(
        False, "check every floating output of the train step (forward, backward and "
        "update) for NaN/Inf and raise at the first offending op with its module path; "
        "with --steps_per_dispatch it drives one checked eager step at a time. "
        "Debugging mode, several times the step cost; single-host only")
    device: str = _flag("cuda", "device to train on: cuda, or cpu for the plain "
                        "PyTorch versions of the kernels")

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.lr_schedule not in ("constant", "cosine", "linear"):
            raise ValueError(f"unknown lr_schedule {self.lr_schedule!r}")
        if self.gan_loss not in ("bce", "hinge", "wgan-gp"):
            raise ValueError(f"unknown gan_loss {self.gan_loss!r}")


@dataclass(frozen=True)
class SampleConfig(ModelConfig, BaseConfig):
    """Per-stage sample grids from a trained G-LIS run (`gea.cli.sample`).
    G and D are rebuilt from the run's own config.json: the model flags
    inherited here select nothing."""

    load_path: str = _flag("", "experiment directory of the trained run")
    save_path_samples: str = _flag("", "output directory for sample PNGs")
    count: int = _flag(64, "number of samples to generate")
    batch_size: int = _flag(64, "generation batch size")
    seed: int = _flag(0, "PRNG seed for the noise batch")
    grid_rows: int = _flag(8, "rows of each output grid")
    d_filter: bool = _flag(
        False, "error-avoidance resampling: render oversample*batch candidates, score the "
        "final LIS stage with the run's discriminator and keep only the best batch")
    oversample: int = _flag(4, "candidate multiplier for --d_filter resampling")
    d_threshold: float = _flag(
        0.0, "with --d_filter: absolute-quality rejection sampling: keep only candidates "
        "whose final-stage D score (sigmoid) is >= this, rendering more candidate batches "
        "until the count is filled (instead of relative top-k); 0 keeps the top-k behavior. "
        "The probability reading only holds for --gan_loss bce runs (the sampler warns)")
    d_filter_step: int = _flag(
        0, "with --d_filter: score with the discriminator from THIS checkpoint step instead "
        "of the sampled one (0 = same step as --step, -1 = the best-FID snapshot from "
        "best.json)")
    step: int = _flag(
        0, "checkpoint step to load (0 = latest, -1 = best-FID snapshot from --fid_interval "
        "tracking)")
    save_gif: bool = _flag(
        False, "also write an animated GIF cycling through the LIS stages")
    use_ema: bool = _flag(
        False, "sample from the EMA copy of G's params (runs trained with --g_ema > 0); "
        "fails loudly if the checkpoint has no EMA params")
    device: str = _flag("cuda", "device to sample on: cuda, or cpu for the plain PyTorch "
                        "versions of the kernels")


@dataclass(frozen=True)
class SampleInterpolationsConfig(SampleConfig):
    """Interpolation walks between noise vectors, rendered per LIS stage
    (`gea.cli.sample_interpolations`)."""

    interp_points: int = _flag(8, "number of interpolation steps per pair")
    interp_pairs: int = _flag(8, "number of (z_a, z_b) pairs to walk")
    interp_mode: str = _flag("slerp", "interpolation mode", choices=("slerp", "lerp"))


@dataclass(frozen=True)
class TrainRConfig(ModelConfig, DataConfig):
    """Flags shared by the two reverser trainers (`gea`'s `TrainRConfig`)."""

    lr: float = _flag(0.0002, "Adam learning rate")
    lr_schedule: str = _flag(
        "constant", "learning-rate schedule over --niter steps: cosine or linear decay "
        "from --lr to --lr_final * --lr", choices=("constant", "cosine", "linear"))
    lr_final: float = _flag(0.0, "final learning rate as a FRACTION of --lr")
    beta1: float = _flag(0.5, "Adam beta1")
    beta2: float = _flag(0.999, "Adam beta2")
    niter: int = _flag(20_000, "number of training iterations")
    lambda_r: float = _flag(
        0.9, "weight of the z-similarity penalty ||R(G(z)) - z||^2 keeping the "
        "corrected code close to the original")
    fid_interval: int = _flag(
        0, "track proxy-FID every N steps and pin the best checkpoint (best.json; --step -1): "
        "R-separate scores CORRECTED samples G(blend(z, R(G(z)))), R-iterative the end of the "
        "correction chain. 0 disables")
    fid_samples: int = _flag(1024, "sample count per --fid_interval evaluation (real and fake)")
    seed: int = _flag(42, "PRNG seed")
    save_path: str = _flag("runs/r", "experiment directory for outputs")
    load_path: str = _flag("", "resume this R run from its directory")
    save_interval: int = _flag(2000, "checkpoint every N iterations")
    keep_checkpoints: int = _flag(0, "retain only the newest K checkpoints (0 = keep all)")
    max_host_rss_gb: float = _flag(
        0.0, "host-RSS budget: checkpoint + exit 19 (for auto-resume) when the process "
        "exceeds it. 0 = auto (85%% of system RAM), negative disables")
    vis_interval: int = _flag(500, "sample grid + loss plot every N iters")
    vis_rows: int = _flag(8, "rows (and cols) of the sample grid")
    log_interval: int = _flag(50, "stdout loss print every N iterations")
    num_devices: int = _flag(0, "data-parallel devices; 0 = all visible (one process on "
                             "the CPU)")
    model_shards: int = _flag(
        1, "tensor parallelism over a 'model' axis of this size (single-host; "
        "gea_torch/parallel/tp.py). 1 = pure data parallel")
    tp_min_width: int = _flag(64, "model_shards > 1: min last-axis width for a leaf to shard")
    steps_per_dispatch: int = _flag(
        1, "fuse K train steps into one dispatch (one CUDA graph replay on the card); "
        "log/vis/save cadences fire at chunk boundaries")
    grad_accum: int = _flag(
        1, "accumulate gradients over K sequential microbatches per optimizer update")
    remat: bool = _flag(
        False, "recompute forward segments in the backward: R-iterative each chain "
        "link, R-separate the corrected frozen-G render and its frozen-D scoring")
    use_pallas: bool = _flag(
        False, "moot in the port: its kernels always run on the card")
    profile_dir: str = _flag(
        "", "if set, write a torch.profiler trace for steps 10..15 here")
    tensorboard: bool = _flag(
        False, "also write scalars to <save_path>/tb via torch.utils.tensorboard")
    multihost: bool = _flag(
        False, "join the process group of a multi-host launch at startup (one process a "
        "card; requires torchrun's RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT or "
        "GEA_COORDINATOR/GEA_NUM_PROCESSES/GEA_PROCESS_ID)")
    debug_checks: bool = _flag(
        False, "check every floating output of the train step (forward, backward and "
        "update) for NaN/Inf and raise at the first offending op with its module path; "
        "with --steps_per_dispatch it drives one checked eager step at a time. "
        "Debugging mode, several times the step cost; single-host only")
    device: str = _flag("cuda", "device to train on: cuda, or cpu for the plain "
                        "PyTorch versions of the kernels")

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.lr_schedule not in ("constant", "cosine", "linear"):
            raise ValueError(f"unknown lr_schedule {self.lr_schedule!r}")


@dataclass(frozen=True)
class TrainRSeparateConfig(TrainRConfig):
    """R-separate (`gea.cli.train_r_separate`): a reverser R trained against
    a frozen G-LIS generator read from --g_path, a port G-LIS run directory."""

    g_path: str = _flag("", "experiment directory of the trained (frozen) generator")
    g_step: int = _flag(
        0, "checkpoint step of the frozen generator (0 = latest, -1 = the best-FID "
        "snapshot that best.json points at)")
    r_hidden: int = _flag(512, "hidden width of the reverser FC head")
    r_adv_weight: float = _flag(
        0.3, "weight of the frozen-D adversarial term on G(R(G(z))); 0 = pure "
        "code-reconstruction MSE")
    r_mse_weight: float = _flag(1.0, "weight of the ||R(G(z)) - z||^2 code-reconstruction term")
    r_mine_weight: float = _flag(
        0.0, "defective-z mining in [0, 1]: re-weight the per-sample reconstruction "
        "loss toward samples the frozen D scores as fake")
    fid_correction_strength: float = _flag(
        0.3, "blend strength of the correction scored by --fid_interval tracking (match "
        "the --correction_strength you will sample with)")


@dataclass(frozen=True)
class TrainRIterativeConfig(TrainRConfig):
    """R-iterative (`gea.cli.train_r_iterative`): G, D and R trained jointly,
    with the correction chain z_{t+1} = z_t + R(G(z_t)) unrolled in each step."""

    r_chain_length: int = _flag(2, "number of reverser correction iterations per step")
    r_hidden: int = _flag(512, "hidden width of the reverser FC head")


# Flags that the port does not implement, each with the values it accepts
# besides its default, and why it refuses the others; the three trainers'
# configs share the list.
UNPORTED = {
    "use_pallas": ((), "moot: the port always runs its kernels on the card"),
}


def refuse_unported(cfg: BaseConfig) -> None:
    """SystemExit naming every flag set to a value the port does not
    implement; none is silently ignored. The defaults are those of the
    config's own class, and a config checks the flags it has: the
    trainers' have every one."""
    defaults = {f.name: f.default for f in dataclasses.fields(type(cfg))}
    bad = [
        f"--{name} {getattr(cfg, name)} ({why})"
        for name, (ok, why) in UNPORTED.items()
        if name in defaults and getattr(cfg, name) != defaults[name]
        and getattr(cfg, name) not in ok
    ]
    if bad:
        raise SystemExit("not implemented in gea_torch: " + "; ".join(bad))


def dispatch_chunk(cfg) -> int:
    """K train steps per dispatch (`--steps_per_dispatch`; 1 = one eager
    step per iteration; below 1 counts as 1, as in `gea`)."""
    return max(1, cfg.steps_per_dispatch)


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
