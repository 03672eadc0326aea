"""The port's tensor parallelism (`gea_torch.parallel.tp`, `--model_shards`)
against `gea`'s single-device step and `gea`'s GSPMD tensor-parallel step,
in fp32 on the CPU at the tiny configs of the step tests.

`gea` runs one program on the global batch: once jitted on one device, and
once partitioned by GSPMD over `make_mesh(4, model_shards=2)` of the
conftest's virtual CPU devices (`state_shardings` with tp_min_width 8,
`make_gspmd_input_step`). Both draw their noise inside the step from
`fold_in(state.rng, state.step)`; the test draws it the same way. The port
runs gloo worlds of data 1 x model 2 and data 2 x model 2
(`gea_torch.parallel.spawn`, with a timeout that fails the test on a
hang); each rank takes its rows of the global real batch and of the
single-device draws (`TensorParallel.rows`), keeps the full parameters
and holds its shards of Adam's moments and the EMA. After 1 and 3 steps the metrics
agree to rtol 1e-5, every full parameter (gathered) to atol 1e-5, every
running statistic to atol 1e-6 + rtol 1e-5 and Adam's full first moments
to atol 1e-6 + rtol 1e-5, for G-LIS (BCE, `--norm batch`, `--grad_accum
2`, and `--grad_accum 4`, whose microbatch of 2 rows splits over 2 ranks
at 1 x 2 and is shared by the model ranks of each data row at 2 x 2),
R-separate (with the mining weights, normalised over the global batch) and
R-iterative (weight and batch norm). The port is held to the GSPMD step
too: for plain G-LIS and R-separate with every wide leaf sharded; under
`--grad_accum`, R-iterative and batch norm with every wide leaf but G's
seed projection sharded, since sharding that leaf on the 2 x 2 mesh moves
the metrics of `gea`'s GSPMD step on XLA:CPU off its own single-device
step's (ROADMAP.md, Queue C; `scripts/gspmd_tp_probe.py`).

Under `--norm batch` a conv bias that feeds a batch norm has a gradient
that is zero up to rounding (`tests/test_torch_port_batchnorm_steps.py`
says why): its moments are held below 1e-5 and its values are not
compared; after each step the GSPMD run and the port take the
single-device run's values, so that the running means that include it
stay comparable.

Also: the leaf rule is `gea`'s, the port shards exactly the parameters
`gea` shards, every rank ends with the same parameters and statistics bit
for bit, each rank's rows are as described, and a rank keeps less of its
state than a single process: the same full parameters and gradients, less
Adam state and EMA.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_tp_workers as workers
from jax.sharding import NamedSharding, PartitionSpec
from test_torch_port_batchnorm_steps import bn_fed_biases, is_stat, jitter_stats, port_layout
from test_torch_port_r_iterative import draws as rit_draws
from test_torch_port_r_separate import configs as rsep_configs
from test_torch_port_r_separate import draws as rsep_draws
from test_torch_port_r_separate import params as rsep_params
from test_torch_port_train import draws as glis_draws
from test_torch_port_train import jitter

from gea.config import TrainGLISConfig as JaxTrainGLISConfig
from gea.config import TrainRIterativeConfig as JaxTrainRIterativeConfig
from gea.models import Discriminator as JaxDiscriminator
from gea.models import GeneratorLIS as JaxGeneratorLIS
from gea.models import Reverter as JaxReverter
from gea.parallel.mesh import make_mesh
from gea.parallel.tp import leaf_spec as jax_leaf_spec
from gea.parallel.tp import make_gspmd_input_step, shard_state, state_shardings
from gea.train.state import GANTrainState
from gea.train.state import make_optimizer as jax_make_optimizer
from gea.train.steps import build_glis_train_step as jax_build_glis_train_step
from gea.train.steps_r import build_r_iterative_step as jax_build_r_iterative_step
from gea.train.steps_r import build_r_separate_step as jax_build_r_separate_step
from gea_torch import interop
from gea_torch.config import TrainGLISConfig, TrainRIterativeConfig
from gea_torch.parallel import spawn
from gea_torch.parallel.tp import leaf_spec, shard_axes
from gea_torch.train.state import generator_config

M, MIN_WIDTH, STEPS, SPAWN_TIMEOUT_S = 2, 8, 3, 240
WORLDS = {"1x2": 2, "2x2": 4}
KEY = jax.random.PRNGKey(0)
TINY = dict(image_size=16, code_size=16, r_iterations=1, norm="weight", num_features=4,
            max_features=16, dtype="float32", batch_size=8, lr=1e-3, r_hidden=32)
# case -> (trainer, flags)
CASES = {
    "glis": ("glis", {}),
    "glis_batch_norm": ("glis", {"norm": "batch"}),
    "glis_grad_accum": ("glis", {"grad_accum": 2}),
    "glis_microbatch": ("glis", {"grad_accum": 4}),
    "r_separate": ("r_separate", {"r_mine_weight": 0.5}),
    "r_iterative": ("r_iterative", {}),
    "r_iterative_batch_norm": ("r_iterative", {"norm": "batch"}),
}
SPECS = {"g": interop.generator_specs, "d": interop.discriminator_specs,
         "r": interop.reverter_specs}


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def real_batches(cfg):
    return [np.random.default_rng(30 + i).uniform(
        -1, 1, (cfg.batch_size, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
        for i in range(STEPS)]


def bn_stats(models: dict, tags: str, seed: int = 3) -> dict:
    """Jittered initial batch_stats of each player under batch norm."""
    shapes = {"g": jnp.zeros((1, 16)), "d": jnp.zeros((1, 16, 16, 3)),
              "r": jnp.zeros((1, 16, 16, 3))}
    return {t: jitter_stats(models[t].init(KEY, shapes[t])["batch_stats"], seed + i)
            for i, t in enumerate(tags)}


def setup(case: str) -> dict:
    """`gea`'s initial state and unjitted step of `case`, its per-step
    inputs, its draw function, the cfgs of the players by tag, and what the
    port's ranks are given."""
    trainer, kw = CASES[case]
    batch_norm = kw.get("norm") == "batch"
    if trainer == "glis":
        glis_tiny = {k: v for k, v in TINY.items() if k != "r_hidden"}
        cfg = JaxTrainGLISConfig(**{**glis_tiny, **kw}, dataset="synthetic")
        pcfg = TrainGLISConfig(**{**glis_tiny, **kw})
        models = {"g": JaxGeneratorLIS.from_config(cfg), "d": JaxDiscriminator.from_config(cfg)}
        init = {"g": jitter(interop.init_generator_params(pcfg, 0), 1),
                "d": jitter(interop.init_discriminator_params(pcfg, 1), 2)}
        tags, cfgs = "gd", {"g": cfg, "d": cfg}
        reals = real_batches(cfg)

        def draw(state):
            z, sn, eps = glis_draws(state, cfg, models["g"])
            return {"z": z, "spatial_noise": sn, "gp_eps": eps}
    elif trainer == "r_separate":
        cfg, pcfg = rsep_configs(kw)
        g_params, d_params, r_params = rsep_params(pcfg)
        models = {"g": JaxGeneratorLIS.from_config(cfg), "d": JaxDiscriminator.from_config(cfg),
                  "r": JaxReverter.from_config(cfg)}
        init = {"r": r_params}
        tags, cfgs = "r", {"r": cfg}
        reals = [None] * STEPS

        def draw(state):
            z, sn = rsep_draws(state, cfg, models["g"])
            return {"z": z, "spatial_noise": sn}
    else:
        kw = {**kw, "r_iterations": 0, "r_chain_length": 2}
        cfg = JaxTrainRIterativeConfig(**{**TINY, **kw}, dataset="synthetic")
        pcfg = TrainRIterativeConfig(**{**TINY, **kw})
        models = {"g": JaxGeneratorLIS.from_config(cfg, r_iterations=0),
                  "d": JaxDiscriminator.from_config(cfg), "r": JaxReverter.from_config(cfg)}
        init = {"g": jitter(interop.init_generator_params(generator_config(pcfg), 0), 1),
                "d": jitter(interop.init_discriminator_params(pcfg, 1), 2),
                "r": jitter(interop.init_reverter_params(pcfg, 2), 3)}
        tags, cfgs = "gdr", {"g": cfg.replace(r_iterations=0), "d": cfg, "r": cfg}
        reals = real_batches(cfg)

        def draw(state):
            z, sn = rit_draws(state, cfg, models["g"])
            return {"z": z, "spatial_noise": sn}
    stats = bn_stats(models, tags) if batch_norm else {}
    txs = {t: jax_make_optimizer(cfg.lr, cfg.beta1, cfg.beta2) for t in tags}
    fields = {}
    for t in tags:
        fields.update({f"params_{t}": init[t], f"opt_{t}": txs[t].init(init[t]),
                       f"extras_{t}": {"batch_stats": stats[t]} if t in stats else {}})
    state = GANTrainState(**{"params_g": {}, "params_d": {}, "extras_g": {}, "extras_d": {},
                             "opt_g": {}, "opt_d": {}, **fields},
                          step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0))
    if trainer == "glis":
        step = jax_build_glis_train_step(cfg, models["g"], models["d"], txs["g"], txs["d"])
        port_init = (init["g"], init["d"])
    elif trainer == "r_separate":
        step = jax_build_r_separate_step(
            cfg, models["g"], models["r"], {"params": g_params}, txs["r"],
            discriminator=models["d"], frozen_d_variables={"params": d_params})
        port_init = (g_params, d_params, r_params)
    else:
        step = jax_build_r_iterative_step(cfg, models["g"], models["d"], models["r"],
                                          txs["g"], txs["d"], txs["r"])
        port_init = init
    raws = [np.zeros((2,), np.float32) if r is None else r for r in reals]
    return {"state": state, "step": step, "raws": raws, "draw": draw, "cfgs": cfgs,
            "port": {"trainer": trainer, "cfg": pcfg, "init": port_init, "reals": reals,
                     "stats": stats or None}}


def fed_paths(tag: str, cfg) -> dict:
    """Port key -> `gea` params path of the conv biases that feed a batch
    norm."""
    specs = {key: path for key, coll, path, _ in SPECS[tag](cfg) if coll != "batch_stats"}
    return {k: specs[k] for k in bn_fed_biases(
        [key for key, *_ in SPECS[tag](cfg)])}


def with_values(tree, path, value):
    """A copy of a nested dict with `path` set to `value`."""
    if not path:
        return value
    return {**tree, path[0]: with_values(tree[path[0]], path[1:], value)}


def but_project(shardings):
    """`shardings` with G's seed projection (its params, EMA and Adam
    moments) replicated: the one leaf whose sharding sets off XLA:CPU's
    fault on a 2-D mesh (`scripts/gspmd_tp_probe.py`)."""
    def f(path, sh):
        name = jax.tree_util.keystr(path)
        if "['core']['project']" in name and name.startswith((".params_g", ".opt_g")):
            return NamedSharding(sh.mesh, PartitionSpec())
        return sh
    return jax.tree_util.tree_map_with_path(
        f, shardings, is_leaf=lambda x: isinstance(x, NamedSharding))


def gea_run(case: str, mode: str, sync=None) -> dict:
    """`STEPS` of `gea`'s step, jitted on one device ("single") or
    partitioned over the ('data', 'model') mesh ("gspmd", or
    "gspmd_but_project" with G's seed projection replicated): the draws, and
    after each step the metrics and the players in the port's layout; with
    `sync` (per step, tag -> {port key: value}), the batch-norm-fed biases
    take those values after each step."""
    s = setup(case)
    state, step = s["state"], s["step"]
    if mode == "single":
        run = jax.jit(step)
        place = lambda st: st  # noqa: E731
    else:
        mesh = make_mesh(4, model_shards=M)
        sh = state_shardings(state, mesh, min_width=MIN_WIDTH)
        if mode == "gspmd_but_project":
            sh = but_project(sh)
        pstep = make_gspmd_input_step(lambda st, raw, rng: step(st, raw), mesh, sh)
        run = lambda st, raw: pstep(st, raw, KEY)  # noqa: E731
        place = lambda st: shard_state(st, sh)  # noqa: E731
        state = place(state)
    out = {"draws": [], "steps": [], "port": s["port"]}
    for i, raw in enumerate(s["raws"]):
        out["draws"].append(s["draw"](state))
        state, metrics = run(state, jnp.asarray(raw))
        host = jax.device_get(state)
        snap = {"metrics": {k: float(v) for k, v in metrics.items()}}
        for tag, cfg in s["cfgs"].items():
            snap.update(port_layout(host, tag, cfg))
        out["steps"].append(snap)
        if sync is not None and sync[i]:
            fields = {}
            for tag, values in sync[i].items():
                tree = getattr(host, f"params_{tag}")
                for key, path in fed_paths(tag, s["cfgs"][tag]).items():
                    tree = with_values(tree, path, values[key])
                fields[f"params_{tag}"] = tree
            state = place(host.replace(**fields))
    out["sync"] = [{tag: {k: np.asarray(snap[tag][k], np.float32)
                          for k in bn_fed_biases(snap[tag])} for tag in s["cfgs"]}
                   for snap in out["steps"]]
    if not any(v for per_step in out["sync"] for v in per_step.values()):
        out["sync"] = None
    return out


@functools.cache
def references(cases: tuple) -> dict:
    out = {}
    for case in cases:
        single = gea_run(case, "single")
        out[case] = {"single": single}
        gspmd = gspmd_ref(case)
        out[case][gspmd] = gea_run(case, gspmd, single["sync"])
    return out


@functools.cache
def port_world(cases: tuple, world: str) -> dict:
    """`cases` on a gloo world, fed the single-device draws and synced to
    the single-device run's batch-norm-fed biases."""
    given = {}
    for case, ref in references(cases).items():
        single = ref["single"]
        given[case] = {**single["port"], "draws": single["draws"], "sync": single["sync"]}
    return spawn(workers.parity, WORLDS[world], torch.device("cpu"),
                 args=(given, M, MIN_WIDTH), timeout=SPAWN_TIMEOUT_S)


def assert_close(got: dict, want: dict) -> None:
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, err_msg=k)
    for tag in [k for k in want if k in ("g", "d", "r")]:
        assert set(got[tag]) == set(want[tag])
        fed = bn_fed_biases(want[tag])
        for k, v in want[tag].items():
            if k in fed:
                continue
            tol = dict(atol=1e-6, rtol=1e-5) if is_stat(k) else dict(atol=1e-5, rtol=0)
            np.testing.assert_allclose(got[tag][k].numpy(), np.asarray(v), **tol,
                                       err_msg=f"{tag} {k}")
        for k, v in want[f"mu_{tag}"].items():
            v = np.asarray(v)
            if k in fed:  # a gradient that is zero up to rounding
                assert max(np.abs(v).max(), got[f"mu_{tag}"][k].abs().max()) < 1e-5, k
                continue
            np.testing.assert_allclose(got[f"mu_{tag}"][k].numpy(), v, atol=1e-6, rtol=1e-5,
                                       err_msg=f"mu_{tag} {k}")


# gea's GSPMD step equals its single-device step (to 1e-7) in these cases.
# In the others, on XLA:CPU, sharding G's seed projection on the 2 x 2 mesh
# moves the step's metrics off the single program's (ROADMAP.md, Queue C;
# `scripts/gspmd_tp_probe.py`), so there the port is held to the GSPMD step
# with every other wide leaf sharded.
GSPMD_AGREES = ("glis", "r_separate")


def gspmd_ref(case: str) -> str:
    return "gspmd" if case in GSPMD_AGREES else "gspmd_but_project"


def refs(cases) -> list:
    """(case, reference) pairs to compare the port with."""
    return [(c, r) for c in cases for r in ("single", gspmd_ref(c))]


# This file's cases; test_torch_port_tp_r.py and test_torch_port_tp_bn.py
# run the others through the same tests.
HERE = ("glis", "glis_grad_accum", "glis_microbatch")


@pytest.mark.parametrize("after", [1, STEPS])
@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("case,ref", refs(HERE))
def test_tp_step_matches_geas(case, ref, world, after):
    got = port_world(HERE, world)[case]["steps"][after - 1]
    assert_close(got, references(HERE)[case][ref]["steps"][after - 1])


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("case", HERE)
def test_ranks_hold_the_same_state(case, world):
    """Every rank's full parameters and statistics, bit for bit."""
    assert port_world(HERE, world)[case]["spread"] == 0.0


@pytest.mark.parametrize("world", list(WORLDS))
def test_a_rank_stores_less_than_the_whole(world):
    """A rank's parameters, gradients, Adam state and EMA, each storage
    counted once, against a single process's: the full parameters and
    gradients alike, less Adam state and EMA, and less in all."""
    for case, run in port_world(HERE, world).items():
        got, whole = run["resident"], run["whole"]
        assert got["params"] == whole["params"] and got["grads"] == whole["grads"], case
        assert got["adam"] < whole["adam"] and got["ema"] <= whole["ema"], case
        assert sum(got.values()) < sum(whole.values()), case


@pytest.mark.parametrize("shape,shards,width,sharded", [
    ((3, 3, 16, 32), 4, 16, True), ((16, 32), 4, 16, True), ((32,), 4, 16, True),
    ((2,), 4, 16, False), ((), 4, 16, False), ((3, 3, 16, 30), 4, 16, False),
    ((3, 3, 16, 32), 4, 64, False)])
def test_leaf_spec_is_geas_rule(shape, shards, width, sharded):
    """`tests/test_tp.py::test_leaf_spec_rule`'s cases, against `gea`."""
    got = leaf_spec(shape, shards, width)
    assert got == tuple(jax_leaf_spec(shape, shards, width))
    assert bool(got) == sharded


@pytest.mark.parametrize("width", [8, 16, 64])
@pytest.mark.parametrize("case", ["glis", "glis_batch_norm", "r_iterative"])
def test_port_shards_exactly_what_gea_shards(case, width):
    """`gea`'s `state_shardings` over its whole state, mapped to the port's
    names through the interop specs, against `shard_axes` of the port's
    modules: the same parameters, and the EMA shadow and Adam's moments of
    each with its parameter."""
    s = setup(case)
    state = s["state"]
    if case == "glis":
        state = state.replace(params_g_ema=jax.tree_util.tree_map(np.copy, state.params_g))
    sh = state_shardings(state, make_mesh(4, model_shards=M), min_width=width)
    port = s["port"]
    from torch_port_dp_workers import port_state

    pstate, _ = port_state(port["trainer"], port["cfg"], port["init"], stats=port["stats"])
    every = set()
    for name, tag in pstate.PLAYERS:
        cfg = s["cfgs"][tag]
        specs = [(k, p) for k, coll, p, _ in SPECS[tag](cfg) if coll == "params"]

        def sharded(tree):
            return {k for k, p in specs
                    if functools.reduce(lambda t, x: t[x], p, tree).spec != PartitionSpec()}

        want = sharded(getattr(sh, f"params_{tag}"))
        assert sharded(getattr(sh, f"opt_{tag}")[0].mu) == want
        assert sharded(getattr(sh, f"opt_{tag}")[0].nu) == want
        if tag == "g" and case == "glis":
            assert sharded(sh.params_g_ema) == want
        axes = shard_axes(getattr(pstate, name), M, width)
        assert {k for k, ax in axes.items() if ax is not None} == want
        every |= {(tag, k) for k in want}
    assert every  # the tiny models shard something at each width


@pytest.mark.parametrize("world", list(WORLDS))
def test_rows_of_each_rank(world):
    """The microbatch case (batch 8, 4 microbatches of 2 rows): at 1 x 2
    each rank takes one row of each microbatch; at 2 x 2 each data row
    takes one, shared by its two model ranks."""
    rows = spawn(workers.draws_of_ranks, WORLDS[world], torch.device("cpu"),
                 args=(8, 4, M), timeout=SPAWN_TIMEOUT_S)
    if world == "1x2":
        assert rows == [[0, 2, 4, 6], [1, 3, 5, 7]]
    else:
        assert rows == [[0, 2, 4, 6], [0, 2, 4, 6], [1, 3, 5, 7], [1, 3, 5, 7]]
