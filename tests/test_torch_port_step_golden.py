"""The flagship G-LIS train step's golden (`tests/torch_port_step_golden.json`
and its draws, `tests/torch_port_step_draws.npz`), written from `gea` on
the CPU: the step that `--steps_per_dispatch` captures in a CUDA graph on
the card, where there is no JAX.

Recipe (RECIPE below): the flagship config in fp32, G from
`init_generator_params(cfg, 0)` and D from `init_discriminator_params(cfg,
1)` (the port's seeded inits, which `gea` is handed too), fresh Adam at the
default lr, BCE, batch 4, one real batch from numpy; two steps, with the z
that `gea`'s own step draws (`fold_in(PRNGKey(0)'s state rng, step)`),
kept in the .npz so that the card feeds the same numbers. The golden holds
each step's metrics and, after step 2, the L2 norm of every parameter of G
and D (the port's names).

Here `gea` and the port are held against it on the CPU. Step 1's metrics
come from the same params on both sides: rtol 1e-5, as the tiny step tests
hold them. Everything after it comes through Adam's first update, which is
about lr * sign(g) per element: a gradient that is zero up to rounding
flips the sign of its element's update on one side only, moving that
element by 2 * lr = 4e-4 (measured: the norm of a G bias near 5e-3 moves
by up to 2.4e-5, step 2's loss_g by 1.4e-5 relative). So step 2's metrics
get rtol 1e-4, and the norms rtol 1e-5 beside atol 1e-4, a quarter of one
such flip; a missed or doubled update would move a norm by lr * sqrt(n).
`tests/test_torch_port_steps_card.py` holds the card's eager and graphed
fp32 steps against the golden at 2e-2 / 2%.

Rewrite both files with `python tests/test_torch_port_step_golden.py
--write` (about a minute).
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

from gea.config import TrainGLISConfig as JaxTrainGLISConfig  # noqa: E402
from gea.interop.torch_port import (  # noqa: E402
    discriminator_to_torch_state,
    generator_to_torch_state,
)
from gea.models import Discriminator as JaxDiscriminator  # noqa: E402
from gea.models import GeneratorLIS as JaxGeneratorLIS  # noqa: E402
from gea.train.state import create_glis_state as jax_create_glis_state  # noqa: E402
from gea.train.state import make_optimizer as jax_make_optimizer  # noqa: E402
from gea.train.steps import build_glis_train_step as jax_build_glis_train_step  # noqa: E402
from gea_torch.config import FLAGSHIP, TrainGLISConfig  # noqa: E402
from gea_torch.interop import init_discriminator_params, init_generator_params  # noqa: E402
from gea_torch.train import build_glis_train_step, create_glis_state  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "torch_port_step_golden.json"
DRAWS = ROOT / "torch_port_step_draws.npz"
RECIPE = {"config": "FLAGSHIP with dtype float32, gan_loss bce, lr 2e-4, batch 4",
          "g_seed": 0, "d_seed": 1, "steps": 2,
          "real": "np.random.default_rng(3).uniform(-1, 1, (4, 80, 80, 3)).astype(np.float32)",
          "z": "gea's draws: fold_in(create_glis_state(seed=0).rng, step), step 0 and 1"}
STEPS = 2


def config() -> TrainGLISConfig:
    fields = {k: getattr(FLAGSHIP, k) for k in (
        "image_size", "code_size", "norm", "r_iterations", "num_features", "max_features")}
    return TrainGLISConfig(**fields, dtype="float32", batch_size=4, dataset="synthetic")


def real_batch() -> np.ndarray:
    return np.random.default_rng(3).uniform(-1, 1, (4, 80, 80, 3)).astype(np.float32)


def params(cfg):
    return init_generator_params(cfg, 0), init_discriminator_params(cfg, 1)


def norms(state_dict) -> dict:
    return {k: float(np.linalg.norm(np.asarray(v, np.float64))) for k, v in state_dict.items()}


@functools.cache
def gea_steps() -> dict:
    """`gea`'s two steps: metrics, z drawn, and the norms after step 2."""
    cfg = config()
    jcfg = JaxTrainGLISConfig(**{f: getattr(cfg, f) for f in (
        "image_size", "code_size", "norm", "r_iterations", "num_features", "max_features",
        "dtype", "batch_size", "lr", "gan_loss")}, dataset="synthetic")
    g, d = JaxGeneratorLIS.from_config(jcfg), JaxDiscriminator.from_config(jcfg)
    txs = [jax_make_optimizer(jcfg.lr, jcfg.beta1, jcfg.beta2) for _ in range(2)]
    state = jax_create_glis_state(jcfg, g, d, *txs, seed=0)
    pg, pd = params(cfg)
    state = state.replace(params_g=pg, params_d=pd, opt_g=txs[0].init(pg),
                          opt_d=txs[1].init(pd))
    step = jax.jit(jax_build_glis_train_step(jcfg, g, d, *txs))
    z, metrics = [], []
    for i in range(STEPS):
        z.append(np.asarray(jax.random.normal(
            jax.random.split(jax.random.fold_in(state.rng, i), 3)[0],
            (cfg.batch_size, cfg.code_size), jnp.float32)))
        state, m = step(state, jnp.asarray(real_batch()))
        metrics.append({k: float(v) for k, v in m.items()})
    host = jax.device_get(state)
    return {"metrics": metrics, "z": np.stack(z),
            "norms": {"g": norms(generator_to_torch_state(host.params_g, jcfg)),
                      "d": norms(discriminator_to_torch_state(host.params_d, jcfg))}}


def port_steps() -> dict:
    cfg = config()
    state = create_glis_state(cfg, *params(cfg), device="cpu")
    step = build_glis_train_step(cfg)
    z = np.load(DRAWS)["z"]
    metrics = [{k: float(v) for k, v in step(state, torch.from_numpy(real_batch()),
                                               torch.from_numpy(z[i])).items()}
               for i in range(STEPS)]
    return {"metrics": metrics,
            "norms": {"g": norms(state.generator.state_dict()),
                      "d": norms(state.discriminator.state_dict())}}


def write():
    jax.config.update("jax_default_matmul_precision", "highest")
    ref = gea_steps()
    np.savez(DRAWS, z=ref["z"])
    golden = {"recipe": RECIPE, "jax_version": jax.__version__, "metrics": ref["metrics"],
              "norms": ref["norms"]}
    GOLDEN.write_text(json.dumps(golden, indent=1) + "\n")
    print(f"wrote {GOLDEN} and {DRAWS}")


def assert_matches_golden(got: dict) -> None:
    golden = json.loads(GOLDEN.read_text())
    assert golden["recipe"] == RECIPE
    for i, (have, want) in enumerate(zip(got["metrics"], golden["metrics"], strict=True)):
        assert set(have) == set(want)
        for k in want:
            np.testing.assert_allclose(have[k], want[k], rtol=1e-5 if i == 0 else 1e-4,
                                       err_msg=f"step {i + 1} {k}")
    for part in ("g", "d"):
        assert set(got["norms"][part]) == set(golden["norms"][part])
        for k, want in golden["norms"][part].items():
            np.testing.assert_allclose(got["norms"][part][k], want, rtol=1e-5, atol=1e-4,
                                       err_msg=f"{part} {k}")


def test_geas_draws_are_the_committed_ones():
    np.testing.assert_array_equal(gea_steps()["z"], np.load(DRAWS)["z"])


@pytest.mark.parametrize("steps", [gea_steps, port_steps], ids=["gea", "port"])
def test_flagship_step_matches_the_golden(steps):
    assert_matches_golden(steps())


if __name__ == "__main__" and "--write" in sys.argv:
    write()
