"""The port's export and serving (`gea_torch.cli.export_model`,
`gea_torch.serve`) against `gea`'s (`gea.cli.export_model`, `gea.serve`), in
fp32 on the CPU at a tiny config.

Run directories of both packages hold the same jittered weights: `gea`'s
as orbax checkpoints, the port's as `state.pt`. Each case is exported by
both CLIs for the CPU (`gea` as StableHLO, the port as a `torch.export`
program) and both artifacts render the same numpy z. Tolerances: uint8
images and stages within 1 level (the two packages sum in other orders,
and a value on a level's edge may round either way), scores atol 1e-5.
"""

import argparse
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gea import serve as jax_serve
from gea.cli import export_model as jax_export_model
from gea.config import TrainGLISConfig as JaxTrainGLISConfig
from gea.config import TrainRIterativeConfig as JaxTrainRIterativeConfig
from gea.config import TrainRSeparateConfig as JaxTrainRSeparateConfig
from gea.train.state import GANTrainState
from gea.utils import checkpoint as jax_ckpt
from gea_torch import serve
from gea_torch.cli import export_model, sample
from gea_torch.config import TrainGLISConfig, TrainRIterativeConfig, TrainRSeparateConfig
from gea_torch.interop import (
    generator_state_from_jax_params,
    init_discriminator_params,
    init_generator_params,
    init_reverter_params,
)
from gea_torch.ops import lis, seed, tprelu
from gea_torch.train import create_glis_state, create_r_iterative_state, create_r_state
from gea_torch.train.state import generator_config
from gea_torch.utils import checkpoint as ckpt

TINY = dict(image_size=16, code_size=16, num_features=4, max_features=16, dtype="float32",
            batch_size=8, dataset="synthetic", crop_size=32)
R_TINY = dict(TINY, r_hidden=32)
STEP = 2
OPS = {"fused_tprelu": tprelu, "lis_residual_mlp": lis, "fused_seed": seed}

# case -> (run kind, run flag, export flags, batches rendered)
CASES = {
    "glis_all_stages": ("glis", "--load_path", ["--all_stages", "1", "--with_scores", "1"],
                        (1, 3, 5)),
    "use_ema": ("glis", "--load_path", ["--use_ema"], (1, 3, 5)),
    "pinned_spatial": ("glis_sc", "--load_path", ["--batch", "4", "--all_stages", "1"], (4,)),
    "r_path": ("rsep", "--r_path", ["--correction_steps", "2", "--all_stages", "1"],
               (1, 3, 5)),
    "ri_path": ("riter", "--ri_path", ["--chain_links", "3", "--all_stages", "1"], (1, 3, 5)),
}


def jitter(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


def jax_state(step, **kw):
    """A `gea` train state with only the given params (the rest empty)."""
    fields = dict(step=jnp.asarray(step, jnp.int32), rng=jax.random.PRNGKey(0), params_g={},
                  params_d={}, extras_g={}, extras_d={}, opt_g={}, opt_d={}, params_r={},
                  extras_r={}, opt_r={}, params_g_ema={})
    return GANTrainState(**{**fields, **kw})


def save_glis(root, name, cfg: dict, seed):
    """A G-LIS run of each package with G, D and an EMA shadow at STEP."""
    runs = str(root / "gea" / name), str(root / "port" / name)
    pcfg = TrainGLISConfig(**cfg)
    JaxTrainGLISConfig(**cfg).save(os.path.join(runs[0], "config.json"))
    pcfg.save(os.path.join(runs[1], "config.json"))
    g = jitter(init_generator_params(pcfg, seed), seed + 1)
    d = jitter(init_discriminator_params(pcfg, seed + 2), seed + 3)
    g_ema = jitter(g, seed + 4)
    jax_ckpt.save_checkpoint(runs[0], STEP, jax_state(STEP, params_g=g, params_d=d,
                                                      params_g_ema=g_ema))
    state = create_glis_state(pcfg, g, d, device="cpu")
    state.g_ema = dict(generator_state_from_jax_params(g_ema, pcfg))
    state.step = STEP
    ckpt.save_checkpoint(runs[1], STEP, state)
    return runs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{kind: (gea run, port run)}: G-LIS (one LIS module, EMA), G-LIS with
    spatial noise, R-separate against the G-LIS run, R-iterative."""
    root = tmp_path_factory.mktemp("runs")
    glis = dict(TINY, r_iterations=1, g_ema=0.5)
    out = {"glis": save_glis(root, "glis", glis, 0),
           "glis_sc": save_glis(root, "glis_sc", dict(glis, spatial_code=2), 50)}
    r = jitter(init_reverter_params(TrainRSeparateConfig(**R_TINY, r_iterations=1), 2), 4)
    riter = dict(R_TINY, r_chain_length=2)
    icfg = TrainRIterativeConfig(**riter)
    gi = jitter(init_generator_params(generator_config(icfg), 5), 6)
    di, ri = jitter(init_discriminator_params(icfg, 6), 7), jitter(init_reverter_params(icfg, 7), 8)
    for side, pkg in ((0, "gea"), (1, "port")):
        rsep = dict(R_TINY, r_iterations=1, g_path=out["glis"][side])
        run_r, run_i = str(root / pkg / "rsep"), str(root / pkg / "riter")
        if pkg == "gea":
            JaxTrainRSeparateConfig(**rsep).save(os.path.join(run_r, "config.json"))
            jax_ckpt.save_checkpoint(run_r, STEP, jax_state(STEP, params_r=r))
            JaxTrainRIterativeConfig(**riter).save(os.path.join(run_i, "config.json"))
            jax_ckpt.save_checkpoint(run_i, STEP, jax_state(STEP, params_g=gi, params_d=di,
                                                            params_r=ri))
            jax_ckpt.wait_for_checkpoints()
        else:
            rcfg = TrainRSeparateConfig(**rsep)
            g, _ = sample.load_generator(out["glis"][side], device="cpu")
            state = create_r_state(rcfg, g, None, r, device="cpu")
            state.step = STEP
            rcfg.save(os.path.join(run_r, "config.json"))
            ckpt.save_checkpoint(run_r, STEP, state)
            state = create_r_iterative_state(icfg, gi, di, ri, device="cpu")
            state.step = STEP
            icfg.save(os.path.join(run_i, "config.json"))
            ckpt.save_checkpoint(run_i, STEP, state)
        out.setdefault("rsep", [None, None])[side] = run_r
        out.setdefault("riter", [None, None])[side] = run_i
    return out


@pytest.fixture(scope="module")
def artifact_dirs(runs, tmp_path_factory):
    """{case: (gea artifact, port artifact)}: each case exported by both
    CLIs for the CPU, the port's with its selfcheck."""
    root = tmp_path_factory.mktemp("artifacts")
    out = {}
    for case, (kind, flag, extra, _) in CASES.items():
        out[case] = str(root / "gea" / case), str(root / "port" / case)
        jax_export_model.main([flag, runs[kind][0], "--out", out[case][0], "--platforms", "cpu",
                               "--selfcheck", "0"] + extra)
        export_model.main([flag, runs[kind][1], "--out", out[case][1], "--platforms", "cpu",
                           "--device", "cpu"] + extra)
    return out


@pytest.fixture(scope="module")
def artifacts(artifact_dirs):
    """{case: (gea ServingModel, port ServingModel)}."""
    return {case: (jax_serve.load(g), serve.load(p, device="cpu"))
            for case, (g, p) in artifact_dirs.items()}


def codes(model, n, seed):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, model.code_size)).astype(np.float32)
    sn = model.spatial_noise_shape
    return z, (rng.standard_normal((n, *sn)).astype(np.float32) if sn else None)


def assert_same_render(got, want):
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        if k == "scores":
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0)
        else:
            assert np.abs(got[k].astype(np.int16) - want[k].astype(np.int16)).max() <= 1, k


@pytest.mark.parametrize("case,n", [(c, n) for c, v in CASES.items() for n in v[3]])
def test_artifact_matches_gea(artifacts, case, n):
    jax_model, port_model = artifacts[case]
    z, sn = codes(port_model, n, n)
    assert_same_render(port_model(z, sn), jax_model(z, sn))


UNSHARED = ("format", "calling_convention_version", "jax_version", "torch_version",
            "source_run")


@pytest.mark.parametrize("case", list(CASES))
def test_manifest_matches_gea(artifacts, case):
    """Every key of `gea`'s manifest but the paths, the format and the
    versions."""
    want, got = (dict(m.manifest) for m in artifacts[case])
    for m in (want, got):
        if m["correction"]:
            m["correction"] = {k: v for k, v in m["correction"].items() if k != "r_run"}
    shared = set(want) - set(UNSHARED)
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    assert got["format"] == "torch.export/pt2" and got["torch_version"] == torch.__version__


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts each kernel's forward calls on the CPU (the plain versions)."""
    calls = dict.fromkeys(OPS, 0)
    for name, mod in OPS.items():
        def counted(*args, _f=mod._forward, _n=name):
            calls[_n] += 1
            return _f(*args)
        monkeypatch.setattr(mod, "_forward", counted)
    return calls


def live_model(runs, case) -> serve.ServingModel:
    """The port's live render of a case: the modules the CLI would export."""
    kind, flag, extra, _ = CASES[case]
    return export_model.live_model(export_model.parse(
        [flag, runs[kind][1], "--out", "unused", "--device", "cpu", "--platforms", "cpu"]
        + extra))[0]


@pytest.mark.parametrize("case", list(CASES))
def test_program_calls_the_kernels_as_the_live_render_does(artifacts, runs, case,
                                                           kernel_calls):
    """The exported graph holds one node of each custom op per kernel
    launch of the live render of the same function (which
    `tests/test_torch_port_trainers_card.py` counts as launches on the card), and the artifact renders what the live
    modules render."""
    model = artifacts[case][1]
    nodes = dict.fromkeys(OPS, 0)
    for node in model.exported.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith("gea_torch."):
            nodes[str(node.target).split(".")[1]] += 1
    live = live_model(runs, case)
    z, sn = codes(live, CASES[case][3][0], 0)
    want = live(z, sn)
    assert nodes == kernel_calls and nodes["fused_seed"] > 0 and nodes["fused_tprelu"] > 0
    got = model(z, sn)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# ------------------------------------------------------------------ serving


@pytest.mark.parametrize("depth", [1, 4])
def test_stream_equals_sequential_calls(artifacts, depth):
    """Order kept, mixed batch sizes through the symbolic batch, the tail
    drained after the input ends."""
    model = artifacts["glis_all_stages"][1]
    rng = np.random.default_rng(3)
    batches = [rng.standard_normal((n, 16)).astype(np.float32) for n in (2, 5, 1, 4, 3)]
    streamed = list(model.stream(iter(batches), depth=depth))
    assert len(streamed) == len(batches)
    for z, got in zip(batches, streamed):
        want = model(z)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_stream_in_flight_bound():
    """stream(depth=D) keeps at most D batches in flight: with lazy
    iteration, exactly D renders are enqueued before the first yield
    (`gea`'s `test_stream_in_flight_bound`)."""
    calls = []

    def render(z):
        calls.append(z.shape[0])
        return {"images": z}

    model = serve.ServingModel(render, {"code_size": 4, "batch": 0}, device="cpu")
    gen = model.stream(iter([np.zeros((i + 1, 4), np.float32) for i in range(5)]), depth=2)
    first = next(gen)
    assert len(calls) == 2 and first["images"].shape[0] == 1
    rest = list(gen)
    assert len(calls) == 5 and [r["images"].shape[0] for r in rest] == [2, 3, 4, 5]


def test_stream_and_call_validate(artifacts):
    model = artifacts["glis_all_stages"][1]
    z = np.zeros((2, 16), np.float32)
    with pytest.raises(ValueError, match="z must be"):
        list(model.stream(iter([z[:, :8]])))
    with pytest.raises(ValueError, match="no spatial noise"):
        list(model.stream(iter([(z, np.zeros((2, 4, 4, 2)))])))
    with pytest.raises(ValueError, match="depth"):
        list(model.stream(iter([z]), depth=0))
    pinned = artifacts["pinned_spatial"][1]
    z4, sn4 = codes(pinned, 4, 0)
    with pytest.raises(ValueError, match="pinned batch of 4"):
        pinned(z4[:2], sn4[:2])
    with pytest.raises(ValueError, match="spatial_code"):
        pinned(z4)
    with pytest.raises(ValueError, match="spatial_noise must be"):
        pinned(z4, sn4[:, :2])
    # sample() renders whole pinned batches and cuts to count.
    got, want = (m.sample(6, seed=2) for m in artifacts["pinned_spatial"][::-1])
    assert got["images"].shape == (6, 16, 16, 3) and got["stages"].shape[1] == 6
    assert_same_render(got, want)


def test_sample_filtered_matches_gea(artifacts):
    """The same candidates (numpy draws from the same seed), scored and cut
    to the top count; untied scores give the same images in the same
    order."""
    jax_model, port_model = artifacts["glis_all_stages"]
    kw = dict(count=5, seed=3, batch_size=4, oversample=3)
    got, want = port_model.sample_filtered(**kw), jax_model.sample_filtered(**kw)
    assert np.all(np.diff(got["scores"]) <= 0)
    assert np.min(np.abs(np.diff(want["scores"]))) > 1e-4  # no near-ties at this seed
    assert_same_render(got, want)


def test_threshold_on_a_non_bce_artifact_warns(runs, tmp_path, capsys):
    """A threshold on a hinge run's artifact prints `gea`'s warning, as
    `gea.serve` does for the same run; top-k prints none (beside the
    sampler's `test_threshold_on_a_non_bce_run_warns`)."""
    models = []
    for side, (mod, load, extra) in enumerate((
            (jax_export_model, jax_serve.load, ["--selfcheck", "0"]),
            (export_model, lambda d: serve.load(d, device="cpu"), ["--device", "cpu"]))):
        run = str(tmp_path / f"hinge{side}")
        os.makedirs(run)
        cfg = (JaxTrainGLISConfig if side == 0 else TrainGLISConfig).load(
            os.path.join(runs["glis"][side], "config.json"))
        cfg.replace(gan_loss="hinge").save(os.path.join(run, "config.json"))
        os.symlink(os.path.join(runs["glis"][side], "checkpoints"),
                   os.path.join(run, "checkpoints"))
        mod.main(["--load_path", run, "--out", str(tmp_path / f"art{side}"),
                  "--platforms", "cpu"] + extra)
        assert "--gan_loss hinge" in capsys.readouterr().out  # the export's note
        models.append(load(str(tmp_path / f"art{side}")))
    for model, tag in zip(models, ("[gea.serve]", "[gea_torch.serve]")):
        assert model.manifest["gan_loss"] == "hinge"
        model.sample_filtered(2, batch_size=4, oversample=2)
        assert "warning" not in capsys.readouterr().out
        model.sample_filtered(2, batch_size=4, oversample=2, threshold=0.5, max_rounds=2)
        assert f"{tag} warning: artifact was trained with gan_loss=hinge" in (
            capsys.readouterr().out)


def test_serve_main_writes_what_gea_writes(artifact_dirs, tmp_path):
    """`python -m gea_torch.serve` against `python -m gea.serve` on the same
    weights: samples.png and scores.json, the scores within 1e-5."""
    import json

    from PIL import Image

    from gea_torch.serve import _main

    gea_art, port_art = artifact_dirs["glis_all_stages"]
    args = ["--count", "5", "--batch_size", "3", "--rows", "2", "--d_filter", "1"]
    jax_serve._main([gea_art, "--out", str(tmp_path / "gea")] + args)
    wrote = _main([port_art, "--out", str(tmp_path / "port"), "--device", "cpu"] + args)
    assert [os.path.basename(p) for p in wrote] == ["samples.png", "scores.json"]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "gea"))
    got, want = (json.load(open(tmp_path / d / "scores.json")) for d in ("port", "gea"))
    np.testing.assert_allclose(got, want, atol=1e-5)
    a, b = (np.asarray(Image.open(tmp_path / d / "samples.png"), np.int16)
            for d in ("port", "gea"))
    assert a.shape == b.shape and np.abs(a - b).max() <= 1
    with pytest.raises(SystemExit, match="only apply with --d_filter"):
        _main([port_art, "--device", "cpu", "--d_threshold", "0.5"])


def test_load_refuses(artifact_dirs, tmp_path):
    port_dir = artifact_dirs["glis_all_stages"][1]
    lone = tmp_path / "lone"
    lone.mkdir()
    with open(os.path.join(port_dir, serve.ARTIFACT), "rb") as f:
        (lone / serve.ARTIFACT).write_bytes(f.read())
    with pytest.raises(FileNotFoundError, match="manifest"):
        serve.load(str(lone), device="cpu")
    with pytest.raises(FileNotFoundError, match="export_model"):
        serve.load(str(tmp_path / "missing"), device="cpu")
    (lone / serve.MANIFEST).write_text('{"platforms": ["cuda"], "code_size": 16}')
    with pytest.raises(ValueError, match="exported for"):
        serve.load(str(lone), device="cpu")


@pytest.mark.parametrize("argv,match", [
    (["--platforms", "cpu,tpu"], "--platforms takes"),
    (["--platforms", "cuda"], "not among --platforms"),
    (["--ri_path", "x", "--load_path", "y"], "mutually exclusive"),
    (["--batch", "-1"], "--batch must be"),
])
def test_export_refuses(argv, match):
    with pytest.raises(SystemExit, match=match):
        export_model.main(["--out", "unused", "--device", "cpu"] + argv)


# -------------------------------------------------------------------- flags


class _Parsed(Exception):
    pass


def cli_flags(fn, monkeypatch) -> dict:
    """{--flag: default} of the parser that `fn([])` builds."""
    flags = {}

    def record(parser, *args, **kw):
        flags.update({o: a.default for a in parser._actions for o in a.option_strings
                      if o.startswith("--") and o != "--help"})
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", record)
        with pytest.raises(_Parsed):
            fn([])
    return flags


@pytest.mark.parametrize("entry", ["cli.export_model:main", "serve:_main", "serve_http:main"])
def test_cli_takes_every_flag_of_gea(entry, monkeypatch):
    """Every flag of `gea`'s entry point, with its default; the port adds
    --device (default cuda) and declares its artifacts for cuda,cpu."""
    module, fn = entry.split(":")
    want = cli_flags(getattr(importlib.import_module(f"gea.{module}"), fn), monkeypatch)
    got = cli_flags(getattr(importlib.import_module(f"gea_torch.{module}"), fn), monkeypatch)
    assert got.pop("--device") == "cuda"
    if "--platforms" in want:
        assert (want.pop("--platforms"), got.pop("--platforms")) == ("cpu,tpu", "cuda,cpu")
    assert got == want
