"""The flagship R-separate and R-iterative train steps' golden
(`tests/torch_port_r_step_golden.json` and its draws,
`tests/torch_port_r_step_draws.npz`), written from `gea` on the CPU, as
`tests/test_torch_port_step_golden.py` holds the G-LIS step.

Recipe (RECIPE below): the flagship architecture in fp32 at batch 4,
fresh Adam at the default lr. R-separate: the frozen G-LIS G
(`init_generator_params(cfg, 0)`, 3 LIS modules) and D
(`init_discriminator_params(cfg, 1)`), R from `init_reverter_params(cfg,
2)`; R-iterative: G without LIS modules (seed 0), D (seed 1) and R (seed 2),
chain length 2, one real batch from numpy. One step each, with the z that
`gea`'s step draws (`fold_in(PRNGKey(0), 0)`), kept in the .npz. The golden
holds each step's metrics and, after it, the L2 norm of every parameter the
step trains (R; G, D and R), in the port's names.

Both steps run the seed kernel's backward: R-separate asks it for dz alone
(G is frozen), R-iterative for every gradient. Here `gea` and the port are
held against the golden on the CPU with the G-LIS golden's tolerances: the
metrics come from the same params on both sides (rtol 1e-5), the norms
through Adam's first update (rtol 1e-5 beside atol 1e-4; the G-LIS golden's
docstring says why).

Rewrite both files with `python tests/test_torch_port_r_step_golden.py
--write`.
"""

import functools
import json
import os
import pathlib
import sys

if __name__ == "__main__":  # the writer runs outside pytest and its conftest
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from gea.config import TrainRIterativeConfig as JaxTrainRIterativeConfig  # noqa: E402
from gea.config import TrainRSeparateConfig as JaxTrainRSeparateConfig  # noqa: E402
from gea.interop.torch_port import (  # noqa: E402
    discriminator_to_torch_state,
    generator_to_torch_state,
    reverter_to_torch_state,
)
from gea.models import Discriminator as JaxDiscriminator  # noqa: E402
from gea.models import GeneratorLIS as JaxGeneratorLIS  # noqa: E402
from gea.models import Reverter as JaxReverter  # noqa: E402
from gea.train.state import GANTrainState  # noqa: E402
from gea.train.state import make_optimizer as jax_make_optimizer  # noqa: E402
from gea.train.steps_r import build_r_iterative_step as jax_build_r_iterative_step  # noqa: E402
from gea.train.steps_r import build_r_separate_step as jax_build_r_separate_step  # noqa: E402
from gea_torch.config import FLAGSHIP, TrainRIterativeConfig, TrainRSeparateConfig  # noqa: E402
from gea_torch.interop import (  # noqa: E402
    discriminator_from_jax_params,
    generator_from_jax_params,
    init_discriminator_params,
    init_generator_params,
    init_reverter_params,
)
from gea_torch.train import (  # noqa: E402
    build_r_iterative_step,
    build_r_separate_step,
    create_r_iterative_state,
    create_r_state,
)
from gea_torch.train.state import generator_config  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "torch_port_r_step_golden.json"
DRAWS = ROOT / "torch_port_r_step_draws.npz"
RECIPE = {"config": "FLAGSHIP architecture, dtype float32, default lr, batch 4",
          "r_separate": "frozen G (3 LIS modules, seed 0) and D (seed 1), R seed 2",
          "r_iterative": "G (no LIS module, seed 0), D (seed 1), R (seed 2), chain length 2",
          "real": "np.random.default_rng(3).uniform(-1, 1, (4, 80, 80, 3)).astype(np.float32)",
          "z": "gea's draws: fold_in(PRNGKey(0), 0), split, the first half"}
ARCH = ("image_size", "code_size", "norm", "num_features", "max_features")


def configs(kind: str):
    fields = {k: getattr(FLAGSHIP, k) for k in ARCH}
    fields.update(dtype="float32", batch_size=4)
    if kind == "r_separate":
        fields["r_iterations"] = FLAGSHIP.r_iterations
        return (JaxTrainRSeparateConfig(**fields, dataset="synthetic"),
                TrainRSeparateConfig(**fields))
    return (JaxTrainRIterativeConfig(**fields, r_chain_length=2, dataset="synthetic"),
            TrainRIterativeConfig(**fields, r_chain_length=2))


def real_batch() -> np.ndarray:
    return np.random.default_rng(3).uniform(-1, 1, (4, 80, 80, 3)).astype(np.float32)


def params(kind: str, pcfg) -> dict:
    g_cfg = pcfg if kind == "r_separate" else generator_config(pcfg)
    return {"g": init_generator_params(g_cfg, 0), "d": init_discriminator_params(pcfg, 1),
            "r": init_reverter_params(pcfg, 2)}


def norms(state_dict) -> dict:
    return {k: float(np.linalg.norm(np.asarray(v, np.float64))) for k, v in state_dict.items()}


def draw_z(state, cfg) -> np.ndarray:
    """z exactly as `gea/train/steps_r.py` draws it (no spatial noise at the
    flagship)."""
    z_rng, _ = jax.random.split(jax.random.fold_in(state.rng, state.step))
    return np.array(jax.random.normal(z_rng, (cfg.batch_size, cfg.code_size), jnp.float32))


@functools.cache
def gea_step(kind: str) -> dict:
    """`gea`'s step: metrics, the z drawn, and the trained players' norms."""
    cfg, pcfg = configs(kind)
    p = params(kind, pcfg)
    tx = functools.partial(jax_make_optimizer, cfg.lr, cfg.beta1, cfg.beta2)
    r = JaxReverter.from_config(cfg)
    if kind == "r_separate":
        g, d = JaxGeneratorLIS.from_config(cfg), JaxDiscriminator.from_config(cfg)
        state = GANTrainState(step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0),
                              params_g={}, params_d={}, extras_g={}, extras_d={}, opt_g={},
                              opt_d={}, params_r=p["r"], extras_r={}, opt_r=tx().init(p["r"]))
        step = jax.jit(jax_build_r_separate_step(
            cfg, g, r, {"params": p["g"]}, tx(), discriminator=d,
            frozen_d_variables={"params": p["d"]}))
        assert g.spatial_noise_shape(cfg.batch_size) is None
        z = draw_z(state, cfg)
        state, metrics = step(state, jnp.zeros(()))
        host = jax.device_get(state)
        trained = {"r": norms(reverter_to_torch_state(host.params_r, cfg))}
    else:
        g = JaxGeneratorLIS.from_config(cfg, r_iterations=0)
        d = JaxDiscriminator.from_config(cfg)
        txs = {k: tx() for k in "gdr"}
        state = GANTrainState(
            step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0), params_g=p["g"],
            params_d=p["d"], extras_g={}, extras_d={}, opt_g=txs["g"].init(p["g"]),
            opt_d=txs["d"].init(p["d"]), params_r=p["r"], extras_r={},
            opt_r=txs["r"].init(p["r"]))
        step = jax.jit(jax_build_r_iterative_step(cfg, g, d, r, txs["g"], txs["d"], txs["r"]))
        assert g.spatial_noise_shape(cfg.batch_size) is None
        z = draw_z(state, cfg)
        state, metrics = step(state, jnp.asarray(real_batch()))
        host = jax.device_get(state)
        trained = {"g": norms(generator_to_torch_state(host.params_g, cfg.replace(r_iterations=0))),
                   "d": norms(discriminator_to_torch_state(host.params_d, cfg)),
                   "r": norms(reverter_to_torch_state(host.params_r, cfg))}
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "z": z, "norms": trained}


def port_step(kind: str) -> dict:
    _, pcfg = configs(kind)
    p = params(kind, pcfg)
    z = torch.from_numpy(np.load(DRAWS)[kind])
    if kind == "r_separate":
        g = generator_from_jax_params(p["g"], pcfg, device="cpu")
        d = discriminator_from_jax_params(p["d"], pcfg, device="cpu")
        state = create_r_state(pcfg, g, d, p["r"], device="cpu")
        metrics = build_r_separate_step(pcfg)(state, None, z, None)
        players = {"r": state.reverter}
    else:
        state = create_r_iterative_state(pcfg, p["g"], p["d"], p["r"], device="cpu")
        metrics = build_r_iterative_step(pcfg)(state, torch.from_numpy(real_batch()), z, None)
        players = {"g": state.generator, "d": state.discriminator, "r": state.reverter}
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "norms": {k: norms(m.state_dict()) for k, m in players.items()}}


def write():
    jax.config.update("jax_default_matmul_precision", "highest")
    steps = {kind: gea_step(kind) for kind in ("r_separate", "r_iterative")}
    np.savez(DRAWS, **{kind: s["z"] for kind, s in steps.items()})
    golden = {"recipe": RECIPE, "jax_version": jax.__version__,
              **{kind: {"metrics": s["metrics"], "norms": s["norms"]} for kind, s in steps.items()}}
    GOLDEN.write_text(json.dumps(golden, indent=1) + "\n")
    print(f"wrote {GOLDEN} and {DRAWS}")


def assert_matches_golden(kind: str, got: dict) -> None:
    golden = json.loads(GOLDEN.read_text())
    assert golden["recipe"] == RECIPE
    want = golden[kind]
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, err_msg=f"{kind} {k}")
    assert set(got["norms"]) == set(want["norms"])
    for part, want_norms in want["norms"].items():
        assert set(got["norms"][part]) == set(want_norms)
        for k, v in want_norms.items():
            np.testing.assert_allclose(got["norms"][part][k], v, rtol=1e-5, atol=1e-4,
                                       err_msg=f"{kind} {part} {k}")


@pytest.mark.parametrize("kind", ["r_separate", "r_iterative"])
def test_geas_draws_are_the_committed_ones(kind):
    np.testing.assert_array_equal(gea_step(kind)["z"], np.load(DRAWS)[kind])


@pytest.mark.parametrize("side", ["gea", "port"])
@pytest.mark.parametrize("kind", ["r_separate", "r_iterative"])
def test_flagship_r_step_matches_the_golden(kind, side):
    assert_matches_golden(kind, gea_step(kind) if side == "gea" else port_step(kind))


if __name__ == "__main__" and "--write" in sys.argv:
    write()
