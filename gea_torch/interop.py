"""`gea`'s flax param trees (as numpy arrays) <-> the port's modules.

A copy of the key mapping of `gea/interop/torch_port.py`
(`generator_to_torch_state`, `discriminator_to_torch_state`,
`reverter_to_torch_state`), kept here so the port imports nothing of `gea`,
and extended to `norm=batch`, which `gea`'s bridge refuses:

| gea (flax)                            | port                                 |
|---------------------------------------|--------------------------------------|
| Dense kernel (in, out)                | weight_v / weight (out, in)          |
| Conv kernel HWIO (kh, kw, in, out)    | weight_v / weight (out, in, kh, kw)  |
| ConvT kernel HWIO                     | weight_v / weight (in, out, kh, kw)  |
| scale (out,)                          | weight_g, 1 on every non-output axis |
| TPReLU slope / translation            | a / b                                |
| params .../BatchNorm_0/scale, bias    | <act>.scale / <act>.bias             |
| batch_stats .../BatchNorm_0/mean, var | <act>.mean / <act>.var (buffers)     |

One list of specs per model (`generator_specs`, ...) drives both
directions: `*_state_from_jax_params(params, cfg, batch_stats)` and
`*_state_to_jax(state_dict, cfg) -> (params, batch_stats)`.

`glis_state_from_jax` carries a whole `gea` train state (params, the
extras' batch_stats, optax's Adam state, step, EMA) into the port's
`GLISTrainState`;
`r_separate_state_from_jax` and `r_iterative_state_from_jax` do the same
for the reverser trainers' states.

`init_generator_params` / `init_discriminator_params` /
`init_reverter_params` make seeded random trees in the same layout
(lecun-normal variance, scale 1, slope 0.25, translation 0, zero biases;
batch norm's scale 1 and bias 0), for runs that need no trained weights.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from gea_torch.config import ModelConfig, generator_plan
from gea_torch.models import Discriminator, GeneratorLIS

Params = Dict[str, Any]


# One entry per tensor: (port key, flax collection, path in that
# collection, layout). The layout names the transform between flax's array
# and the port's tensor, so that both directions read the same list.
Spec = Tuple[str, str, Tuple[str, ...], str]
_TO_PORT = {
    "vec": lambda x: x,
    "dense": lambda x: x.T,  # (in, out) -> (out, in)
    "conv": lambda x: x.permute(3, 2, 0, 1),  # HWIO -> OIHW
    "convt": lambda x: x.permute(2, 3, 0, 1),  # HWIO -> IOHW
    "scale_dense": lambda x: x.view(-1, 1),  # weight_g, 1 on every
    "scale_conv": lambda x: x.view(-1, 1, 1, 1),  # non-output axis
    "scale_convt": lambda x: x.view(1, -1, 1, 1),
}
_TO_FLAX = {
    "vec": lambda t: t,
    "dense": lambda t: t.T,
    "conv": lambda t: t.permute(2, 3, 1, 0),
    "convt": lambda t: t.permute(2, 3, 0, 1),
    "scale_dense": lambda t: t.reshape(-1),
    "scale_conv": lambda t: t.reshape(-1),
    "scale_convt": lambda t: t.reshape(-1),
}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _wn(norm: str) -> bool:
    return norm == "weight"


def _weighted(prefix: str, path: Tuple[str, ...], kind: str, wn: bool,
              names=("kernel", "scale", "bias")) -> List[Spec]:
    """A dense, conv or conv-transpose layer: its kernel (weight_v with
    weight norm, else weight), its scale (weight_g) and its bias."""
    kernel, scale, bias = names
    out = [(prefix + (".weight_v" if wn else ".weight"), "params", path + (kernel,), kind)]
    if wn:
        out.append((prefix + ".weight_g", "params", path + (scale,), "scale_" + kind))
    return out + [(prefix + ".bias", "params", path + (bias,), "vec")]


def _tprelu(prefix: str, path: Tuple[str, ...]) -> List[Spec]:
    return [(prefix + ".a", "params", path + ("slope",), "vec"),
            (prefix + ".b", "params", path + ("translation",), "vec")]


def _norm_act(prefix: str, path: Tuple[str, ...], norm: str) -> List[Spec]:
    """`gea`'s NormAct: a TPReLU (weight), a BatchNorm's scale and bias in
    `params` and its running mean and variance in `batch_stats` (batch), or
    nothing (none)."""
    if norm == "weight":
        return _tprelu(prefix, path + ("TPReLU_0",))
    if norm == "batch":
        bn = path + ("BatchNorm_0",)
        return [(prefix + ".scale", "params", bn + ("scale",), "vec"),
                (prefix + ".bias", "params", bn + ("bias",), "vec"),
                (prefix + ".mean", "batch_stats", bn + ("mean",), "vec"),
                (prefix + ".var", "batch_stats", bn + ("var",), "vec")]
    return []


def generator_specs(cfg: ModelConfig) -> List[Spec]:
    wn = _wn(cfg.norm)
    out: List[Spec] = []
    for i in range(cfg.r_iterations):
        for fc in ("fc1", "fc2"):
            out += _weighted(f"lis.{i}.{fc}", (f"lis{i}",), "dense", wn,
                             (f"{fc}_kernel", f"{fc}_scale", f"{fc}_bias"))
        if wn:
            out += _tprelu(f"lis.{i}.act", (f"lis{i}",))
    core = ("core",)
    out += _weighted("project", core + ("project",), "dense", wn)
    out += _norm_act("project_act", core + ("project_act",), cfg.norm)
    _, d = generator_plan(cfg.image_size)
    for i in range(1, d):
        out += _weighted(f"ups.{i - 1}.conv", core + (f"up{i}",), "convt", wn)
        out += _norm_act(f"ups.{i - 1}.act", core + (f"up{i}_act",), cfg.norm)
    return out + _weighted("to_rgb", core + ("to_rgb",), "convt", wn)


def _trunk(cfg: ModelConfig) -> List[Spec]:
    wn = _wn(cfg.norm)
    _, d = generator_plan(cfg.image_size)
    out: List[Spec] = []
    for i in range(d):
        out += _weighted(f"trunk.downs.{i}.conv", ("trunk", f"down{i}"), "conv", wn)
        if i > 0:
            out += _norm_act(f"trunk.downs.{i}.act", ("trunk", f"down{i}_act"), cfg.norm)
    return out


def discriminator_specs(cfg: ModelConfig) -> List[Spec]:
    return _trunk(cfg) + _weighted("head", ("head",), "dense", _wn(cfg.norm))


def reverter_specs(cfg: ModelConfig) -> List[Spec]:
    wn = _wn(cfg.norm)
    out = _trunk(cfg) + _weighted("fc1", ("fc1",), "dense", wn)
    if wn:
        out += _tprelu("act", ("act",))
    return out + _weighted("fc2", ("fc2",), "dense", wn)


def _get(tree: Params, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def _from_jax(specs: List[Spec], params: Params, batch_stats: Params = None) -> OrderedDict:
    """The port's state_dict of a flax `params` tree (and `batch_stats`;
    without one, the running statistics take their initial values: mean
    0, variance 1)."""
    out: OrderedDict = OrderedDict()
    for key, collection, path, layout in specs:
        if collection == "params":
            out[key] = _TO_PORT[layout](_t(_get(params, path))).contiguous()
        elif batch_stats is not None:
            out[key] = _t(_get(batch_stats, path))
        else:
            width = _get(params, path[:-1] + ("scale",)).shape
            out[key] = (torch.zeros if path[-1] == "mean" else torch.ones)(width)
    return out


def _to_jax(specs: List[Spec], state: Dict[str, torch.Tensor]) -> Tuple[Params, Params]:
    """(params, batch_stats) flax trees of numpy arrays from the port's
    state_dict; batch_stats is {} without batch norm."""
    trees: Dict[str, Params] = {"params": {}, "batch_stats": {}}
    for key, collection, path, layout in specs:
        node = trees[collection]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(
            _TO_FLAX[layout](state[key].detach().float().cpu()).numpy())
    return trees["params"], trees["batch_stats"]


def generator_state_from_jax_params(params: Params, cfg: ModelConfig,
                                    batch_stats: Params = None) -> OrderedDict:
    """GeneratorLIS flax params (and batch_stats) -> the port's generator
    state_dict."""
    return _from_jax(generator_specs(cfg), params, batch_stats)


def discriminator_state_from_jax_params(params: Params, cfg: ModelConfig,
                                        batch_stats: Params = None) -> OrderedDict:
    """Discriminator flax params (and batch_stats) -> the port's
    discriminator state_dict."""
    return _from_jax(discriminator_specs(cfg), params, batch_stats)


def reverter_state_from_jax_params(params: Params, cfg: ModelConfig,
                                   batch_stats: Params = None) -> OrderedDict:
    """Reverter flax params (and batch_stats) -> the port's reverter
    state_dict."""
    return _from_jax(reverter_specs(cfg), params, batch_stats)


def generator_state_to_jax(state: Dict[str, torch.Tensor], cfg: ModelConfig):
    """The port's generator state_dict -> (flax params, batch_stats)."""
    return _to_jax(generator_specs(cfg), state)


def discriminator_state_to_jax(state: Dict[str, torch.Tensor], cfg: ModelConfig):
    """The port's discriminator state_dict -> (flax params, batch_stats)."""
    return _to_jax(discriminator_specs(cfg), state)


def reverter_state_to_jax(state: Dict[str, torch.Tensor], cfg: ModelConfig):
    """The port's reverter state_dict -> (flax params, batch_stats)."""
    return _to_jax(reverter_specs(cfg), state)


def _field(tree: Any, name: str) -> Any:
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def _adam_state(opt_state: Any):
    """(count, mu, nu) of optax's `ScaleByAdamState` inside the state of
    `optax.adam`'s chain (with or without a schedule)."""
    for s in opt_state if isinstance(opt_state, (tuple, list)) else (opt_state,):
        try:
            return tuple(_field(s, k) for k in ("count", "mu", "nu"))
        except (KeyError, AttributeError, TypeError):
            continue
    raise ValueError("no Adam state (count, mu, nu) in the optimizer state")


def _load_adam(opt, sched, module, opt_tree: Any, to_port, cfg) -> None:
    """optax's Adam state of one player -> its `torch.optim.Adam`: the
    moments through the params' key mapping, the count as each parameter's
    `step`, and the scheduler set to `count` updates."""
    count, mu, nu = _adam_state(opt_tree)
    count = int(np.asarray(count))
    mu, nu = to_port(mu, cfg), to_port(nu, cfg)
    capturable = opt.param_groups[0]["capturable"]  # its step counts live on the device
    for name, p in module.named_parameters():
        opt.state[p] = {"step": torch.tensor(float(count),
                                             device=p.device if capturable else "cpu"),
                        "exp_avg": mu[name].to(p.device),
                        "exp_avg_sq": nu[name].to(p.device)}
    if sched is not None:
        lrs = [base * fn(count) for base, fn in zip(sched.base_lrs, sched.lr_lambdas)]
        sched.load_state_dict({**sched.state_dict(), "last_epoch": count, "_last_lr": lrs})
        for group, lr in zip(opt.param_groups, lrs):
            if torch.is_tensor(group["lr"]):  # a chunked state's, filled in place
                group["lr"].fill_(lr)
            else:
                group["lr"] = lr


def _stats(state_tree: Any, name: str) -> Params:
    """The batch_stats of a state's extras (`extras_g`, ...), or None."""
    extras = _field(state_tree, name) or {}
    return extras.get("batch_stats")


def glis_state_from_jax(state_tree: Any, cfg, device="cuda", use_kernels: bool = True):
    """A `gea` `GANTrainState` whose leaves are numpy arrays (step,
    params_g, params_d, extras_g, extras_d, opt_g, opt_d, params_g_ema;
    attributes or keys) -> the port's `GLISTrainState`. optax's Adam moments map to
    `torch.optim.Adam`'s `exp_avg` and `exp_avg_sq` through the params' key
    mapping, its count to each parameter's `step`, and the schedulers are
    set to `count` updates. `gea`'s PRNG key has no counterpart: the state's
    `torch.Generator` is seeded with cfg.seed."""
    from gea_torch.train.state import create_glis_state

    state = create_glis_state(cfg, _field(state_tree, "params_g"),
                              _field(state_tree, "params_d"), device=device,
                              use_kernels=use_kernels, g_stats=_stats(state_tree, "extras_g"),
                              d_stats=_stats(state_tree, "extras_d"))
    _load_adam(state.opt_g, state.sched_g, state.generator, _field(state_tree, "opt_g"),
               generator_state_from_jax_params, cfg)
    _load_adam(state.opt_d, state.sched_d, state.discriminator, _field(state_tree, "opt_d"),
               discriminator_state_from_jax_params, cfg)
    ema = _field(state_tree, "params_g_ema")
    if cfg.g_ema > 0 and ema:
        names = dict(state.generator.named_parameters())  # parameters only
        state.g_ema = {n: t.to(state.device) for n, t in
                       generator_state_from_jax_params(ema, cfg).items() if n in names}
    state.step = int(np.asarray(_field(state_tree, "step")))
    return state


def r_separate_state_from_jax(state_tree: Any, cfg, generator: GeneratorLIS,
                              discriminator=None, device="cuda"):
    """A `gea` R-separate `GANTrainState` (step, params_r, extras_r, opt_r;
    numpy leaves) -> the port's `RSeparateTrainState` around the given frozen
    generator (and discriminator), as `glis_state_from_jax` does for G-LIS."""
    from gea_torch.train.state import create_r_state

    state = create_r_state(cfg, generator, discriminator, _field(state_tree, "params_r"),
                           device=device, r_stats=_stats(state_tree, "extras_r"))
    _load_adam(state.opt_r, state.sched_r, state.reverter, _field(state_tree, "opt_r"),
               reverter_state_from_jax_params, cfg)
    state.step = int(np.asarray(_field(state_tree, "step")))
    return state


def r_iterative_state_from_jax(state_tree: Any, cfg, device="cuda"):
    """A `gea` R-iterative `GANTrainState` (step, params_g/d/r,
    extras_g/d/r, opt_g/d/r; numpy leaves) -> the port's `RIterativeTrainState`. G is the
    single-stage generator (r_iterations=0), as `gea` builds it."""
    from gea_torch.train.state import create_r_iterative_state, generator_config

    state = create_r_iterative_state(
        cfg, _field(state_tree, "params_g"), _field(state_tree, "params_d"),
        _field(state_tree, "params_r"), device=device,
        **{f"{k}_stats": _stats(state_tree, f"extras_{k}") for k in "gdr"})
    players = ((state.opt_g, state.sched_g, state.generator, "opt_g",
                generator_state_from_jax_params, generator_config(cfg)),
               (state.opt_d, state.sched_d, state.discriminator, "opt_d",
                discriminator_state_from_jax_params, cfg),
               (state.opt_r, state.sched_r, state.reverter, "opt_r",
                reverter_state_from_jax_params, cfg))
    for opt, sched, module, key, to_port, player_cfg in players:
        _load_adam(opt, sched, module, _field(state_tree, key), to_port, player_cfg)
    state.step = int(np.asarray(_field(state_tree, "step")))
    return state


def generator_from_jax_params(params: Params, cfg: ModelConfig, device="cuda",
                              use_kernels: bool = True, batch_stats: Params = None
                              ) -> GeneratorLIS:
    """G in inference mode from a flax tree (and its batch_stats)."""
    g = GeneratorLIS(cfg, device=device, use_kernels=use_kernels)
    g.load_state_dict(generator_state_from_jax_params(params, cfg, batch_stats), strict=True)
    return g.eval()


def discriminator_from_jax_params(params: Params, cfg: ModelConfig, device="cuda",
                                  use_kernels: bool = True, batch_stats: Params = None
                                  ) -> Discriminator:
    """D in inference mode from a flax tree (and its batch_stats)."""
    d = Discriminator(cfg, device=device, use_kernels=use_kernels)
    d.load_state_dict(discriminator_state_from_jax_params(params, cfg, batch_stats),
                      strict=True)
    return d.eval()


# ------------------------------------------------- seeded random param trees


def _layer(rng: np.random.Generator, shape, fan_in: int, wn: bool) -> Params:
    out = shape[-1]
    p = {
        "kernel": (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32),
        "bias": np.zeros(out, np.float32),
    }
    if wn:
        p["scale"] = np.ones(out, np.float32)
    return p


def _act(ch: int, norm: str = "weight") -> Params:
    """A NormAct's params: a TPReLU's (weight), a BatchNorm's (batch), none
    (none)."""
    if norm == "batch":
        return {"BatchNorm_0": {"scale": np.ones(ch, np.float32),
                                "bias": np.zeros(ch, np.float32)}}
    if norm != "weight":
        return {}
    return {"TPReLU_0": {"slope": np.full(ch, 0.25, np.float32),
                        "translation": np.zeros(ch, np.float32)}}


def init_generator_params(cfg: ModelConfig, seed: int = 0) -> Params:
    wn = _wn(cfg.norm)
    rng = np.random.default_rng(seed)
    s0, d = generator_plan(cfg.image_size)
    nf, cap, code = cfg.num_features, cfg.max_features, cfg.code_size
    hidden = code * cfg.lis_hidden_mult
    params: Params = {}
    for i in range(cfg.r_iterations):
        fc1 = _layer(rng, (code, hidden), code, wn)
        fc2 = _layer(rng, (hidden, code), hidden, wn)
        p = {"fc1_kernel": fc1["kernel"], "fc1_bias": fc1["bias"],
             "fc2_kernel": fc2["kernel"], "fc2_bias": fc2["bias"]}
        if wn:
            p.update(fc1_scale=fc1["scale"], fc2_scale=fc2["scale"],
                     **_act(hidden)["TPReLU_0"])
        params[f"lis{i}"] = p
    c0 = min(nf * 2 ** (d - 1), cap)
    core: Params = {"project": _layer(rng, (code, s0 * s0 * c0), code, wn)}
    if _act(c0, cfg.norm):
        core["project_act"] = _act(c0, cfg.norm)
    ch = c0
    for i in range(1, d):
        ci = min(nf * 2 ** (d - 1 - i), cap)
        cin = ch + (cfg.spatial_code if i == 2 else 0)
        core[f"up{i}"] = _layer(rng, (4, 4, cin, ci), 16 * cin, wn)
        if _act(ci, cfg.norm):
            core[f"up{i}_act"] = _act(ci, cfg.norm)
        ch = ci
    rgb_in = ch + (cfg.spatial_code if d == 2 else 0)
    core["to_rgb"] = _layer(rng, (4, 4, rgb_in, 3), 16 * rgb_in, wn)
    params["core"] = core
    return params


def _init_trunk(rng: np.random.Generator, cfg: ModelConfig, wn: bool) -> Tuple[Params, int]:
    """The conv trunk's params and its flat output width."""
    s0, d = generator_plan(cfg.image_size)
    nf, cap = cfg.num_features, cfg.max_features
    trunk: Params = {}
    ch = 3
    for i in range(d):
        ci = min(nf * 2**i, cap)
        trunk[f"down{i}"] = _layer(rng, (4, 4, ch, ci), 16 * ch, wn)
        if i > 0 and _act(ci, cfg.norm):
            trunk[f"down{i}_act"] = _act(ci, cfg.norm)
        ch = ci
    return trunk, ch * s0 * s0


def init_discriminator_params(cfg: ModelConfig, seed: int = 0) -> Params:
    wn = _wn(cfg.norm)
    rng = np.random.default_rng(seed)
    trunk, flat = _init_trunk(rng, cfg, wn)
    return {"trunk": trunk, "head": _layer(rng, (flat, 1), flat, wn)}


def init_reverter_params(cfg: ModelConfig, seed: int = 0) -> Params:
    """`gea`'s Reverter tree: trunk, fc1, act (slope, translation; weight
    norm only), fc2; hidden width `cfg.r_hidden` (512 where the config has
    none)."""
    wn = _wn(cfg.norm)
    rng = np.random.default_rng(seed)
    hidden = getattr(cfg, "r_hidden", 512)
    trunk, flat = _init_trunk(rng, cfg, wn)
    params = {"trunk": trunk, "fc1": _layer(rng, (flat, hidden), flat, wn),
              "fc2": _layer(rng, (hidden, cfg.code_size), hidden, wn)}
    if wn:
        params["act"] = _act(hidden)["TPReLU_0"]
    return params
