"""Data parallelism on the card at `gea`'s fifth milestone configuration
(G-LIS-3 at 160x160, spatial_code 4, nf 64 / cap 512, bf16, BCE, batch
64), on a process group of world size 1 over NCCL: the DP step bit for bit
the single-process step, with a step's launches; the seed kernel at this
configuration's shape; the DP step's K = 8 graph with its all-reduces
captured, its kernel nodes those of 8 eager steps; a graphed fp32 K = 2
chunk against 2 eager DP steps; the CLIs with --num_devices 1 and
--multihost; `ServingModel.sharded()` against the single card, and
`serve_http --data_parallel`. Needs an NVIDIA card and skips without one;
imports no JAX, so on the card it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_port_dp_card.py
"""

import contextlib
import os
import threading

import numpy as np
import pytest
import torch
from torch_port_card_cases import KERNEL, PLAIN, card, cases, compare  # noqa: F401
from torch_port_card_runs import (
    BATCH,
    DP_ARGS,
    RITER_ARGS,
    TRAINER_ARGS,
    TRAINER_STEPS,
    TRAINER_VIS,
    calls_from,
    chunk_agreement,
    counted_run,
    cudnn_tf32,
    deterministic,
    dp_config,
    dp_params,
    glis_launches,
    graph_text,
    graphs_kept,
    http_post,
    launches,
    r_iterative_launches,
    r_separate_config,
    r_separate_launches,
    real_batch,
    relaunch,
    round_trip,
    times,
)

from gea_torch import ops, serve_http
from gea_torch.cli import train_glis, train_r_iterative, train_r_separate
from gea_torch.config import TrainRIterativeConfig
from gea_torch.interop import (
    discriminator_from_jax_params,
    generator_from_jax_params,
    init_discriminator_params,
    init_generator_params,
)
from gea_torch.parallel import DataParallel, join
from gea_torch.parallel.mesh import Launch, free_port
from gea_torch.serve import ServingModel
from gea_torch.train import build_glis_train_step, create_glis_state
from gea_torch.train.dispatch import StepDispatcher

pytestmark = [pytest.mark.card, pytest.mark.usefixtures("card")]
DP_STEPS, DP_K, DP_REPLAYS = 10, 8, 2
DP_SERVE_BATCHES, DP_HTTP_REQUESTS = (1, 3, 64), 16


@pytest.fixture(scope="module")
def dp(card):  # noqa: F811
    """One process group of world size 1 on NCCL, through a localhost TCP
    store, destroyed after the module."""
    group = DataParallel(join(torch.device("cuda"),
                              Launch(0, 1, 0, f"tcp://127.0.0.1:{free_port()}")))
    assert group.size == 1
    yield group
    torch.distributed.destroy_process_group()


def state_tensors(state) -> dict:
    """Every trained parameter and its Adam state, by name."""
    out = {}
    for name, tag in state.PLAYERS:
        opt = getattr(state, f"opt_{tag}")
        for n, p in getattr(state, name).named_parameters():
            out[f"{name}.{n}"] = p.detach()
            out.update({f"{name}.{n}.{k}": v for k, v in opt.state[p].items()})
    return out


def test_dp_step_is_the_single_process_step(dp):
    """Deterministic algorithms: 10 eager DP steps at world size 1 against
    10 of the single-process step, from the same seeded params with the
    states' own draws; parameters, Adam's state and metrics equal bit for
    bit; the DP run launches 10 steps' kernels."""
    cfg = dp_config()
    params, real = dp_params(cfg), real_batch(cfg)

    def run(dp_):
        state, step = create_glis_state(cfg, *params), build_glis_train_step(cfg, dp=dp_)
        return state, [step(state, real) for _ in range(DP_STEPS)]

    with deterministic():
        single, m_single = run(None)
        ops.reset_launch_counts()
        ranked, m_ranked = run(dp)
        counts = ops.launch_counts()
    ta, tb = state_tensors(ranked), state_tensors(single)
    diffs = [n for n, t in tb.items() if not (ta[n].dtype == t.dtype and torch.equal(ta[n], t))]
    diffs += [f"step {i + 1} {k}" for i, (x, y) in enumerate(zip(m_ranked, m_single))
              for k in y if not torch.equal(x[k], y[k])]
    assert not diffs, f"the world-1 DP step is not the single-process step: {diffs[:8]}"
    assert counts == times(glis_launches(cfg)[0], DP_STEPS)


def test_seed_at_this_configurations_shape(dp):
    """The seed kernel at c0 = c1 = 512, s0 = 5 (the step's stacked codes)
    against its plain version in fp32 and bf16."""
    for name, label, _, per_step, make in cases(dp_config()):
        if name != "fused_seed" or per_step == 0:
            continue
        for dt in (torch.float32, torch.bfloat16):
            args = make(dt)
            compare(name, label, dt, KERNEL[name](*args), PLAIN[name](*args))


def test_dp_graph_captures_the_all_reduces(dp, tmp_path):
    """2 replays of a K = 8 graph of the DP step: the port kernels' calls
    from the graph's own kernel nodes (and the dispatcher's count) equal 8
    eager steps'; NCCL kernel nodes are in the graph; the metrics are
    finite."""
    cfg = dp_config(steps_per_dispatch=DP_K)
    params, real = dp_params(cfg), real_batch(cfg)
    with cudnn_tf32():
        state, step = create_glis_state(cfg, *params), build_glis_train_step(cfg, dp=dp)
        dispatch = StepDispatcher(cfg, step)
        reals = [real] * DP_K
        with graphs_kept():
            dispatch(state, reals)  # warm-up, capture, first replay
        chunk = dispatch.chunks[DP_K]
        text = graph_text(chunk.graph, str(tmp_path))
        nodes = calls_from(text.count)
        per_replay = times(glis_launches(cfg)[0], DP_K)
        assert nodes == per_replay and chunk.launches == per_replay, (
            f"dp graph: kernel nodes {nodes}, dispatcher {chunk.launches}, not {DP_K} steps' "
            f"{per_replay}")
        nccl = sum(1 for node in text.split("];") if "{KERNEL" in node and "nccl" in node.lower())
        print(f"[dp] a replay's kernel nodes: port kernels {nodes}, NCCL {nccl}")
        history = [dispatch(state, reals) for _ in range(DP_REPLAYS)]
    values = {k: v.tolist() for k, v in history[-1].items()}
    assert all(np.isfinite(x) for vs in values.values() for x in vs), values


def test_dp_graphed_fp32_chunk_agrees_with_eager_dp_steps(dp):
    cfg = dp_config(dtype="float32")
    params = dp_params(cfg)
    chunk_agreement("g-lis dp", cfg, lambda c: create_glis_state(c, *params),
                    lambda c: build_glis_train_step(c, dp=dp), real_batch(cfg), None)


@contextlib.contextmanager
def launcher_world():
    """torchrun's environment for a group of world size 1, as --multihost
    reads it (the group started by the fixture is joined, not started)."""
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    kept = {k: os.environ.get(k) for k in keys}
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(free_port()))
    try:
        yield
    finally:
        for k, v in kept.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_dp_clis(dp, tmp_path):
    """The CLIs at this configuration, 40 steps each with exact launches:
    train_glis --num_devices 1; train_glis --multihost under a launcher's
    environment of world size 1, with a bitwise checkpoint round trip and
    a relaunch resuming at 40; train_r_separate against that run and
    train_r_iterative (at the flagship shape), both --multihost."""
    cfg = dp_config()
    per_step, per_render = glis_launches(cfg)
    renders = TRAINER_STEPS // TRAINER_VIS
    common = ["--vis_interval", str(TRAINER_VIS), "--save_interval", str(TRAINER_VIS)]
    want = launches(per_step, TRAINER_STEPS, per_render, renders)
    with cudnn_tf32():
        counted_run("train_glis --num_devices 1", train_glis,
                    DP_ARGS + common + ["--save_path", str(tmp_path / "dp_single"), "--niter",
                                        str(TRAINER_STEPS), "--num_devices", "1"], want)
        run = str(tmp_path / "dp_multihost")
        args = DP_ARGS + common + ["--save_path", run, "--multihost"]
        with launcher_world():
            state, _, text, _ = counted_run("train_glis --multihost", train_glis,
                                            args + ["--niter", str(TRAINER_STEPS)], want)
            assert "multihost: process 0/1" in text, "train_glis --multihost did not join the group"
            round_trip(run, TRAINER_STEPS, state, create_glis_state(cfg))
            del state
            relaunch("train_glis --multihost", train_glis, args, run, per_step, per_render)
            rargs = ["--g_path", run, "--batch_size", str(BATCH), "--log_interval", "10",
                     "--save_path", str(tmp_path / "dp_rsep"), *common, "--multihost"]
            r_step, r_render = r_separate_launches(r_separate_config(run, rargs))
            counted_run("train_r_separate --multihost", train_r_separate,
                        rargs + ["--niter", str(TRAINER_STEPS)],
                        launches(r_step, TRAINER_STEPS, r_render, renders))
            iargs = TRAINER_ARGS + RITER_ARGS + ["--save_path", str(tmp_path / "dp_riter"),
                                                 *common, "--multihost"]
            i_step, i_render = r_iterative_launches(TrainRIterativeConfig.from_args(iargs))
            counted_run("train_r_iterative --multihost", train_r_iterative,
                        iargs + ["--niter", str(TRAINER_STEPS)],
                        launches(i_step, TRAINER_STEPS, i_render, renders))


def test_sharded_serving_and_serve_http_data_parallel(dp):
    """`ServingModel.sharded()` over the visible cards renders what the
    single-card ServingModel renders, bit for bit, in bf16 at batches 1, 3
    and 64; `serve_http --data_parallel` (the final stage alone) answers
    16 requests."""
    cfg = dp_config()
    g = generator_from_jax_params(init_generator_params(cfg, 0), cfg)
    d = discriminator_from_jax_params(init_discriminator_params(cfg, 1), cfg)
    model = ServingModel.from_modules(g, d)
    sharded = model.sharded()
    rng = np.random.default_rng(7)
    for n in DP_SERVE_BATCHES:
        z = rng.standard_normal((n, cfg.code_size)).astype(np.float32)
        sn = rng.standard_normal((n, *model.spatial_noise_shape)).astype(np.float32)
        want, got = model(z, sn), sharded(z, sn)
        diff = [k for k in want if not np.array_equal(want[k], got[k])]
        assert not diff and got["images"].shape[0] == n, f"batch {n} differs in {diff}"
    final = ServingModel.from_modules(g, d, all_stages=False)
    server, batcher = serve_http.make_server("", "127.0.0.1", 0, model=final, data_parallel=True)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        for i in range(DP_HTTP_REQUESTS):
            status, body = http_post(base + "/render", {"count": 4, "seed": i})
            assert status == 200 and len(body["images"]) == 4 and len(body["scores"]) == 4, (
                f"serve_http --data_parallel: request {i} got {status}")
    finally:
        server.shutdown()
        batcher.close()
        thread.join(timeout=30)
