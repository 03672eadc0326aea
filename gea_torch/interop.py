"""`gea`'s flax param trees (as numpy arrays) -> the port's modules.

A copy of the key mapping of `gea/interop/torch_port.py`
(`generator_to_torch_state`, `discriminator_to_torch_state`,
`reverter_to_torch_state`), kept here so the port imports nothing of `gea`:

| gea (flax)                        | port                                 |
|-----------------------------------|--------------------------------------|
| Dense kernel (in, out)            | weight_v / weight (out, in)          |
| Conv kernel HWIO (kh, kw, in, out)| weight_v / weight (out, in, kh, kw)  |
| ConvT kernel HWIO                 | weight_v / weight (in, out, kh, kw)  |
| scale (out,)                      | weight_g, 1 on every non-output axis |
| TPReLU slope / translation        | a / b                                |

`glis_state_from_jax` carries a whole `gea` train state (params, optax's
Adam state, step, EMA) into the port's `GLISTrainState`;
`r_separate_state_from_jax` and `r_iterative_state_from_jax` do the same
for the reverser trainers' states.

`init_generator_params` / `init_discriminator_params` /
`init_reverter_params` make seeded random trees in the same layout (lecun-normal variance, scale 1, slope 0.25,
translation 0, zero biases), for runs that need no trained weights.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Tuple

import numpy as np
import torch

from gea_torch.config import ModelConfig, generator_plan
from gea_torch.models import Discriminator, GeneratorLIS

Params = Dict[str, Any]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _wn(norm: str) -> bool:
    if norm == "batch":
        raise NotImplementedError("norm=batch is not ported yet")
    return norm == "weight"


def _weighted(out: OrderedDict, prefix: str, kernel: torch.Tensor, p: Params,
              wn: bool, out_dim: int) -> None:
    if wn:
        g_shape = [1] * kernel.dim()
        g_shape[out_dim] = kernel.shape[out_dim]
        out[prefix + ".weight_v"] = kernel.contiguous()
        out[prefix + ".weight_g"] = _t(p["scale"]).view(g_shape)
    else:
        out[prefix + ".weight"] = kernel.contiguous()
    out[prefix + ".bias"] = _t(p["bias"])


def _dense(out, prefix, p, wn):
    _weighted(out, prefix, _t(p["kernel"]).T, p, wn, 0)  # (in,out) -> (out,in)


def _conv(out, prefix, p, wn):
    _weighted(out, prefix, _t(p["kernel"]).permute(3, 2, 0, 1), p, wn, 0)  # HWIO -> OIHW


def _convt(out, prefix, p, wn):
    _weighted(out, prefix, _t(p["kernel"]).permute(2, 3, 0, 1), p, wn, 1)  # HWIO -> IOHW


def _tprelu(out, prefix, p):
    out[prefix + ".a"] = _t(p["slope"])
    out[prefix + ".b"] = _t(p["translation"])


def generator_state_from_jax_params(params: Params, cfg: ModelConfig) -> OrderedDict:
    """GeneratorLIS flax params -> the port's generator state_dict."""
    wn = _wn(cfg.norm)
    out: OrderedDict = OrderedDict()
    for i in range(cfg.r_iterations):
        p = params[f"lis{i}"]
        for fc in ("fc1", "fc2"):
            sub = {"kernel": p[f"{fc}_kernel"], "bias": p[f"{fc}_bias"]}
            if wn:
                sub["scale"] = p[f"{fc}_scale"]
            _dense(out, f"lis.{i}.{fc}", sub, wn)
        if wn:
            _tprelu(out, f"lis.{i}.act", p)
    core = params["core"]
    _dense(out, "project", core["project"], wn)
    if wn:
        _tprelu(out, "project_act", core["project_act"]["TPReLU_0"])
    _, d = generator_plan(cfg.image_size)
    for i in range(1, d):
        _convt(out, f"ups.{i - 1}.conv", core[f"up{i}"], wn)
        if wn:
            _tprelu(out, f"ups.{i - 1}.act", core[f"up{i}_act"]["TPReLU_0"])
    _convt(out, "to_rgb", core["to_rgb"], wn)
    return out


def _trunk(out: OrderedDict, trunk: Params, cfg: ModelConfig, wn: bool) -> None:
    _, d = generator_plan(cfg.image_size)
    for i in range(d):
        _conv(out, f"trunk.downs.{i}.conv", trunk[f"down{i}"], wn)
        if i > 0 and wn:
            _tprelu(out, f"trunk.downs.{i}.act", trunk[f"down{i}_act"]["TPReLU_0"])


def discriminator_state_from_jax_params(params: Params, cfg: ModelConfig) -> OrderedDict:
    """Discriminator flax params -> the port's discriminator state_dict."""
    wn = _wn(cfg.norm)
    out: OrderedDict = OrderedDict()
    _trunk(out, params["trunk"], cfg, wn)
    _dense(out, "head", params["head"], wn)
    return out


def reverter_state_from_jax_params(params: Params, cfg: ModelConfig) -> OrderedDict:
    """Reverter flax params -> the port's reverter state_dict."""
    wn = _wn(cfg.norm)
    out: OrderedDict = OrderedDict()
    _trunk(out, params["trunk"], cfg, wn)
    _dense(out, "fc1", params["fc1"], wn)
    if wn:
        _tprelu(out, "act", params["act"])
    _dense(out, "fc2", params["fc2"], wn)
    return out


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


def glis_state_from_jax(state_tree: Any, cfg, device="cuda", use_kernels: bool = True):
    """A `gea` `GANTrainState` whose leaves are numpy arrays (step,
    params_g, params_d, opt_g, opt_d, params_g_ema; attributes or keys) ->
    the port's `GLISTrainState`. optax's Adam moments map to
    `torch.optim.Adam`'s `exp_avg` and `exp_avg_sq` through the params' key
    mapping, its count to each parameter's `step`, and the schedulers are
    set to `count` updates. `gea`'s PRNG key has no counterpart: the state's
    `torch.Generator` is seeded with cfg.seed."""
    from gea_torch.train.state import create_glis_state

    state = create_glis_state(cfg, _field(state_tree, "params_g"),
                              _field(state_tree, "params_d"), device=device,
                              use_kernels=use_kernels)
    _load_adam(state.opt_g, state.sched_g, state.generator, _field(state_tree, "opt_g"),
               generator_state_from_jax_params, cfg)
    _load_adam(state.opt_d, state.sched_d, state.discriminator, _field(state_tree, "opt_d"),
               discriminator_state_from_jax_params, cfg)
    ema = _field(state_tree, "params_g_ema")
    if cfg.g_ema > 0 and ema:
        state.g_ema = {n: t.to(state.device) for n, t in
                       generator_state_from_jax_params(ema, cfg).items()}
    state.step = int(np.asarray(_field(state_tree, "step")))
    return state


def r_separate_state_from_jax(state_tree: Any, cfg, generator: GeneratorLIS,
                              discriminator=None, device="cuda"):
    """A `gea` R-separate `GANTrainState` (step, params_r, opt_r; numpy
    leaves) -> the port's `RSeparateTrainState` around the given frozen
    generator (and discriminator), as `glis_state_from_jax` does for G-LIS."""
    from gea_torch.train.state import create_r_state

    state = create_r_state(cfg, generator, discriminator, _field(state_tree, "params_r"),
                           device=device)
    _load_adam(state.opt_r, state.sched_r, state.reverter, _field(state_tree, "opt_r"),
               reverter_state_from_jax_params, cfg)
    state.step = int(np.asarray(_field(state_tree, "step")))
    return state


def r_iterative_state_from_jax(state_tree: Any, cfg, device="cuda"):
    """A `gea` R-iterative `GANTrainState` (step, params_g/d/r, opt_g/d/r;
    numpy leaves) -> the port's `RIterativeTrainState`. G is the
    single-stage generator (r_iterations=0), as `gea` builds it."""
    from gea_torch.train.state import create_r_iterative_state, generator_config

    state = create_r_iterative_state(
        cfg, _field(state_tree, "params_g"), _field(state_tree, "params_d"),
        _field(state_tree, "params_r"), device=device)
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
                              use_kernels: bool = True) -> GeneratorLIS:
    g = GeneratorLIS(cfg, device=device, use_kernels=use_kernels)
    g.load_state_dict(generator_state_from_jax_params(params, cfg), strict=True)
    return g.eval()


def discriminator_from_jax_params(params: Params, cfg: ModelConfig, device="cuda",
                                  use_kernels: bool = True) -> Discriminator:
    d = Discriminator(cfg, device=device, use_kernels=use_kernels)
    d.load_state_dict(discriminator_state_from_jax_params(params, cfg), strict=True)
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


def _act(ch: int) -> Params:
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
    if wn:
        core["project_act"] = _act(c0)
    ch = c0
    for i in range(1, d):
        ci = min(nf * 2 ** (d - 1 - i), cap)
        cin = ch + (cfg.spatial_code if i == 2 else 0)
        core[f"up{i}"] = _layer(rng, (4, 4, cin, ci), 16 * cin, wn)
        if wn:
            core[f"up{i}_act"] = _act(ci)
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
        if i > 0 and wn:
            trunk[f"down{i}_act"] = _act(ci)
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
