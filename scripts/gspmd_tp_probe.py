"""Probe of `gea`'s GSPMD tensor-parallel step against its own single-device
step, on XLA:CPU's virtual devices, at the tiny configs of
`tests/test_torch_port_tp.py` (whose `setup` builds the states and steps).

For each case it prints the step-1 metrics' largest relative difference
from the single-device step when the state is laid out by `gea`'s
`state_shardings` rule (tp_min_width 8) over a (data, model) mesh, for a
choice of which leaves may shard: every wide leaf, none, only G's seed
projection (`params_g/core/project` and its Adam moments), and every wide
leaf but that projection; and every wide leaf on a mesh with one data row
(1 x 2). With `--trace` it also prints, for the first G-LIS case, the row
sums of each model call's input and the first logits it returns, in the
single-device and the projection-only step, and the largest difference of
D's forward alone (its first state, a seeded batch) with its input sharded
over data, model or both, in a scan over two microbatches and outside one.

    python scripts/gspmd_tp_probe.py [case ...] [--trace]

Cases are the keys of `tests/test_torch_port_tp.py::CASES` (default:
glis, glis_grad_accum, glis_batch_norm, r_iterative). It needs no
accelerator and takes a few minutes on a CPU.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, "..", "tests"), os.path.join(HERE, "..")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import gea.train.steps as gea_steps  # noqa: E402
import test_torch_port_tp as T  # noqa: E402
from gea.parallel.mesh import make_mesh  # noqa: E402
from gea.parallel.tp import leaf_spec, make_gspmd_input_step, shard_state  # noqa: E402

PROJECT = "['core']['project']"
CHOICES = {
    "every wide leaf": lambda name: True,
    "none": lambda name: False,
    "only G's projection": lambda name: PROJECT in name and "_g" in name,
    "all but G's projection": lambda name: not (PROJECT in name and "_g" in name),
}


def metrics(case: str, may_shard=None, devices: int = 4) -> dict:
    """Step 1's metrics: single-device (may_shard None) or GSPMD over
    make_mesh(devices, model_shards=2) with the leaves `may_shard` names
    laid out by `gea`'s rule."""
    s = T.setup(case)
    state, raw = s["state"], jnp.asarray(s["raws"][0])
    if may_shard is None:
        _, m = jax.jit(s["step"])(state, raw)
    else:
        mesh = make_mesh(devices, model_shards=T.M)

        def sharding(path, x):
            spec = leaf_spec(np.shape(x), T.M, T.MIN_WIDTH)
            return NamedSharding(mesh, spec if may_shard(jax.tree_util.keystr(path)) else P())

        sh = jax.tree_util.tree_map_with_path(sharding, state)
        step = make_gspmd_input_step(lambda st, r, rng: s["step"](st, r), mesh, sh)
        _, m = step(shard_state(state, sh), raw, T.KEY)
    return {k: float(v) for k, v in m.items()}


def rel(a: dict, b: dict) -> float:
    return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6) for k in b)


def trace(case: str) -> None:
    """Row sums of each model call's input and its first logits, through a
    debug callback on `gea.train.steps._apply_model`."""
    plain = gea_steps._apply_model
    log = []

    def recorded(model, params, extras, x, train=True, **kw):
        out = plain(model, params, extras, x, train=train, **kw)
        first = out[0]
        while isinstance(first, tuple):
            first = first[0]

        def keep(xs, o, name=type(model).__name__):
            log.append((name, np.asarray(xs).reshape(xs.shape[0], -1).sum(1)[:6].round(4),
                        np.asarray(o).reshape(-1)[:6].round(4)))

        jax.debug.callback(keep, x, first)
        return out

    gea_steps._apply_model = recorded
    try:
        for label, choice in (("single", None), ("only G's projection",
                                                  CHOICES["only G's projection"])):
            log.clear()
            metrics(case, choice)
            print(f"-- {case}, {label}")
            for name, sums, first in log:
                print(f"   {name:14s} input row sums {sums.tolist()}\n"
                      f"   {'':14s} first outputs  {first.tolist()}")
    finally:
        gea_steps._apply_model = plain


def d_alone(case: str) -> None:
    """D's logits on one seeded batch, jitted on one device against jitted
    over the 2 x 2 mesh with the input constrained to each sharding."""
    from jax import lax

    s = T.setup(case)
    params_d, cfg = s["state"].params_d, s["cfgs"]["d"]
    d = T.JaxDiscriminator.from_config(cfg)
    x = jnp.asarray(np.random.default_rng(0).uniform(
        -1, 1, (cfg.batch_size, cfg.image_size, cfg.image_size, 3)).astype(np.float32))
    mesh = make_mesh(4, model_shards=T.M)

    def logits(p, x, scan, spec):
        def one(xm):
            if spec is not None:
                xm = jax.lax.with_sharding_constraint(xm, NamedSharding(mesh, spec))
            return gea_steps._apply_model(d, p, {}, xm, train=True)[0].reshape(-1)
        if not scan:
            return one(x)
        return lax.scan(lambda c, xm: (c, one(xm)), 0.0, x.reshape(2, -1, *x.shape[1:]))[1]

    want = np.asarray(jax.jit(lambda p, x: logits(p, x, False, None))(params_d, x)).reshape(-1)
    for spec in (P("data"), P(None, "model"), P("data", "model")):
        for scan in (False, True):
            got = np.asarray(jax.jit(lambda p, x, sc=scan, sp=spec: logits(p, x, sc, sp))(
                params_d, x)).reshape(-1)
            print(f"-- D alone, input {spec}, {'in' if scan else 'outside'} a scan: max abs "
                  f"{float(np.abs(got - want).max()):.3e}", flush=True)


def main(argv) -> None:
    cases = [a for a in argv if not a.startswith("--")] or [
        "glis", "glis_grad_accum", "glis_batch_norm", "r_iterative"]
    for case in cases:
        single = metrics(case)
        print(f"{case}: single-device {single}")
        for label, choice in CHOICES.items():
            print(f"  data 2 x model 2, {label:24s} rel {rel(metrics(case, choice), single):.3e}",
                  flush=True)
        print(f"  data 1 x model 2, every wide leaf          rel "
              f"{rel(metrics(case, CHOICES['every wide leaf'], devices=2), single):.3e}",
              flush=True)
    if "--trace" in argv:
        case = next(c for c in cases if c.startswith("glis") and c != "glis")
        trace(case)
        d_alone(case)


if __name__ == "__main__":
    main(sys.argv[1:])
