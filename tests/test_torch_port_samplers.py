"""The port's samplers and `info` against `gea`'s, in fp32 on the CPU at a
tiny config, and the port's flagship render against a golden written from
`gea`.

Run directories of both packages hold the same jittered weights: `gea`'s
as orbax checkpoints, the port's as `state.pt`, through the
`gea_torch.interop` converters. The port's samplers take `gea`'s
`jax.random` draws through their `noise=` / `pairs=` hooks, so the images
are the same up to fp32 summation order. Tolerances: images atol 1e-5
(captured where each package hands its stage images to
`save_stage_grids`); uint8 grids within 1 level; `info`'s counts exact.

The golden `tests/torch_port_render_golden.json` holds, for the flagship
in fp32 (random weights from `gea_torch.interop.init_*_params(cfg, 0)`,
batch 4, z from numpy), each stage's and sample's mean, std and 24 fixed
pixels, and D's logit on every stage image, as `gea` renders them on the
CPU; `tests/test_torch_port_trainers_card.py` holds the card's fp32
render to it. Written by

    python tests/test_torch_port_samplers.py --write

Tolerance: atol 1e-5 on the CPU (both packages; measured 1.2e-7), atol 1e-4
on the card (fp32 without TF32, with the kernels).
"""

import argparse
import importlib
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
from PIL import Image, ImageSequence  # noqa: E402

from gea.cli import info as jax_info  # noqa: E402
from gea.cli import sample as jax_sample  # noqa: E402
from gea.cli import sample_interpolations as jax_interp  # noqa: E402
from gea.cli import sample_r_iterative as jax_riter  # noqa: E402
from gea.cli import sample_r_separate as jax_rsep  # noqa: E402
from gea.config import ModelConfig as JaxModelConfig  # noqa: E402
from gea.config import TrainGLISConfig as JaxTrainGLISConfig  # noqa: E402
from gea.config import TrainRIterativeConfig as JaxTrainRIterativeConfig  # noqa: E402
from gea.config import TrainRSeparateConfig as JaxTrainRSeparateConfig  # noqa: E402
from gea.models import Discriminator as JaxDiscriminator  # noqa: E402
from gea.models import GeneratorLIS as JaxGeneratorLIS  # noqa: E402
from gea.train.state import GANTrainState  # noqa: E402
from gea.utils import checkpoint as jax_ckpt  # noqa: E402
from gea_torch.cli import (  # noqa: E402
    info,
    sample,
    sample_interpolations,
    sample_r_iterative,
    sample_r_separate,
)
from gea_torch.config import (  # noqa: E402
    FLAGSHIP,
    TrainGLISConfig,
    TrainRIterativeConfig,
    TrainRSeparateConfig,
)
from gea_torch.interop import (  # noqa: E402
    discriminator_from_jax_params,
    generator_from_jax_params,
    generator_state_from_jax_params,
    init_discriminator_params,
    init_generator_params,
    init_reverter_params,
)
from gea_torch.train import (  # noqa: E402
    create_glis_state,
    create_r_iterative_state,
    create_r_state,
)
from gea_torch.train.state import generator_config  # noqa: E402
from gea_torch.utils import checkpoint as ckpt  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = dict(image_size=16, code_size=16, num_features=4, max_features=16, dtype="float32",
            batch_size=8, dataset="synthetic", crop_size=32)
R_TINY = dict(TINY, r_hidden=32)
STEPS = (2, 4)  # the G-LIS runs' checkpoints; best.json names the first
BEST = STEPS[0]
ATOL = 1e-5


def jitter(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


def jax_noise(generator, seed):
    """`gea`'s sampler draws for the port's: per batch of n,
    rng, z_rng, sn_rng = split(rng, 3) from PRNGKey(seed)."""
    rng = jax.random.PRNGKey(seed)

    def draw(n):
        nonlocal rng
        rng, z_rng, sn_rng = jax.random.split(rng, 3)
        z = np.array(jax.random.normal(z_rng, (n, generator.cfg.code_size), jnp.float32))
        shape = generator.spatial_noise_shape(n)
        sn = None if not shape else np.array(jax.random.normal(sn_rng, shape, jnp.float32))
        return torch.from_numpy(z), None if sn is None else torch.from_numpy(sn)

    return draw


def jax_pairs(generator, seed, n_pairs):
    """`gea`'s interpolation draws: z_rng, sn_rng = split(PRNGKey(seed))."""
    z_rng, sn_rng = jax.random.split(jax.random.PRNGKey(seed))
    pairs = np.array(jax.random.normal(z_rng, (2, n_pairs, generator.cfg.code_size), jnp.float32))
    shape = generator.spatial_noise_shape(n_pairs)
    sn = None if not shape else torch.from_numpy(
        np.array(jax.random.normal(sn_rng, shape, jnp.float32)))
    return torch.from_numpy(pairs), sn


def jax_state(step, **kw):
    """A `gea` train state with only the given params (the rest empty)."""
    fields = dict(step=jnp.asarray(step, jnp.int32), rng=jax.random.PRNGKey(0), params_g={},
                  params_d={}, extras_g={}, extras_d={}, opt_g={}, opt_d={}, params_r={},
                  extras_r={}, opt_r={}, params_g_ema={})
    return GANTrainState(**{**fields, **kw})


def save_glis(root, name, jcfg, pcfg, steps, seed):
    """A G-LIS run of each package with G, D and an EMA shadow at each of
    `steps`, and best.json naming the first. Returns (gea run, port run)."""
    runs = str(root / "gea" / name), str(root / "port" / name)
    jcfg.save(os.path.join(runs[0], "config.json"))
    pcfg.save(os.path.join(runs[1], "config.json"))
    for i, step in enumerate(steps):
        s = seed + 10 * i
        g = jitter(init_generator_params(pcfg, s), s + 1)
        d = jitter(init_discriminator_params(pcfg, s + 2), s + 3)
        g_ema = jitter(g, s + 4)
        jax_ckpt.save_checkpoint(runs[0], step, jax_state(step, params_g=g, params_d=d,
                                                          params_g_ema=g_ema))
        state = create_glis_state(pcfg, g, d, device="cpu")
        state.g_ema = dict(generator_state_from_jax_params(g_ema, pcfg))
        state.step = step
        ckpt.save_checkpoint(runs[1], step, state)
    jax_ckpt.wait_for_checkpoints()
    jax_ckpt.record_best_step(runs[0], steps[0], 1.0, "fid")
    ckpt.record_best_step(runs[1], steps[0], 1.0, "fid")
    return runs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{kind: (gea run, port run)}: G-LIS (one LIS module, EMA, two
    steps), G-LIS with spatial noise, R-separate against the G-LIS run,
    R-iterative."""
    root = tmp_path_factory.mktemp("runs")
    out = {}
    glis = dict(TINY, r_iterations=1, g_ema=0.5)
    out["glis"] = save_glis(root, "glis", JaxTrainGLISConfig(**glis), TrainGLISConfig(**glis),
                            STEPS, 0)
    sc = dict(glis, spatial_code=2)
    out["glis_sc"] = save_glis(root, "glis_sc", JaxTrainGLISConfig(**sc),
                               TrainGLISConfig(**sc), STEPS[:1], 50)

    r = jitter(init_reverter_params(TrainRSeparateConfig(**R_TINY, r_iterations=1), 2), 4)
    riter = dict(R_TINY, r_chain_length=2)
    icfg = TrainRIterativeConfig(**riter)
    gi = jitter(init_generator_params(generator_config(icfg), 5), 6)
    di, ri = jitter(init_discriminator_params(icfg, 6), 7), jitter(init_reverter_params(icfg, 7), 8)
    step = STEPS[0]
    for side, pkg in ((0, "gea"), (1, "port")):
        g_run = out["glis"][side]
        rsep = dict(R_TINY, r_iterations=1, g_path=g_run)
        run_r, run_i = str(root / pkg / "rsep"), str(root / pkg / "riter")
        if pkg == "gea":
            JaxTrainRSeparateConfig(**rsep).save(os.path.join(run_r, "config.json"))
            jax_ckpt.save_checkpoint(run_r, step, jax_state(step, params_r=r))
            JaxTrainRIterativeConfig(**riter).save(os.path.join(run_i, "config.json"))
            jax_ckpt.save_checkpoint(run_i, step, jax_state(step, params_g=gi, params_d=di,
                                                            params_r=ri))
            jax_ckpt.wait_for_checkpoints()
        else:
            rcfg = TrainRSeparateConfig(**rsep)
            g, _ = sample.load_generator(g_run, device="cpu")
            state = create_r_state(rcfg, g, None, r, device="cpu")
            state.step = step
            rcfg.save(os.path.join(run_r, "config.json"))
            ckpt.save_checkpoint(run_r, step, state)
            state = create_r_iterative_state(icfg, gi, di, ri, device="cpu")
            state.step = step
            icfg.save(os.path.join(run_i, "config.json"))
            ckpt.save_checkpoint(run_i, step, state)
        out.setdefault("rsep", [None, None])[side] = run_r
        out.setdefault("riter", [None, None])[side] = run_i
    return out


def capture(monkeypatch, module):
    """The stage images (S, B, H, W, 3) each save_stage_grids call of
    `module` is handed, in order; nothing is written."""
    grids = []
    monkeypatch.setattr(module, "save_stage_grids",
                        lambda images, out_dir, step, rows=8: grids.append(
                            np.asarray(images, np.float32)))
    return grids


def assert_same_grids(got, want):
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, f"batch {i}: {a.shape} != {b.shape}"
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=f"batch {i}")


# -------------------------------------------------------------------- flags

CLIS = ["make_demo_data", "sample", "sample_interpolations", "sample_r_separate",
        "sample_r_iterative", "info", "convert_checkpoint"]


class _Parsed(Exception):
    pass


def cli_flags(module, monkeypatch) -> dict:
    """{--flag: default} of the parser `module.main` builds."""
    flags = {}

    def record(parser, *args, **kw):
        flags.update({o: a.default for a in parser._actions for o in a.option_strings
                      if o.startswith("--") and o != "--help"})
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", record)
        with pytest.raises(_Parsed):
            module.main([])
    return flags


@pytest.mark.parametrize("cli", CLIS)
def test_cli_takes_every_flag_of_gea(cli, monkeypatch):
    """Every flag of `gea`'s CLI, with its default; the port adds only
    --device (to the CLIs that load a model)."""
    want = cli_flags(importlib.import_module(f"gea.cli.{cli}"), monkeypatch)
    got = cli_flags(importlib.import_module(f"gea_torch.cli.{cli}"), monkeypatch)
    extra = got.pop("--device", None)
    assert got == want
    assert extra == ("cuda" if cli.startswith("sample") else None)


# ------------------------------------------------------------------- sample

SAMPLE = {
    "plain": [],
    "d_filter": ["--d_filter", "--oversample", "3"],
    "d_threshold_fill": ["--d_filter", "--d_threshold", "0.9999"],
    "d_threshold_early": ["--d_filter", "--d_threshold", "{early}"],
    "use_ema": ["--use_ema"],
    "step_best": ["--step", "-1"],
    "d_filter_step": ["--d_filter", "--d_filter_step", str(BEST)],
    "d_filter_step_best": ["--d_filter", "--d_filter_step", "-1", "--use_ema"],
    "spatial_noise": ["--d_filter", "--oversample", "2"],
}


def early_threshold(port_run):
    """A --d_threshold that 2 of the first round's 16 candidates clear
    (midway between the 2nd and 3rd best sigmoid scores), so the sampler
    draws more rounds and stops early."""
    g, _ = sample.load_generator(port_run, device="cpu")
    d = sample.load_discriminator(port_run, device="cpu")
    z, sn = jax_noise(g, 0)(16)
    with torch.no_grad():
        scores = torch.sigmoid(d(g.render(z, sn)[0][-1])).sort(descending=True).values
    return float((scores[1] + scores[2]) / 2)


@pytest.mark.parametrize("case", list(SAMPLE))
def test_sample_matches_gea(runs, case, monkeypatch, capsys, tmp_path):
    kind = "glis_sc" if case == "spatial_noise" else "glis"
    early = early_threshold(runs[kind][1]) if case == "d_threshold_early" else None
    extra = [a.format(early=early) for a in SAMPLE[case]]
    base = ["--count", "10", "--batch_size", "4", "--grid_rows", "2"] + extra
    want = capture(monkeypatch, jax_sample)
    jax_sample.main(["--load_path", runs[kind][0], "--save_path_samples",
                     str(tmp_path / "gea")] + base)
    gea_out = capsys.readouterr().out
    got = capture(monkeypatch, sample)
    result = sample.main(["--load_path", runs[kind][1], "--device", "cpu",
                          "--save_path_samples", str(tmp_path / "port")] + base, noise=jax_noise)
    port_out = capsys.readouterr().out
    assert [g.shape[1] for g in got] == [4, 4, 2] and result["batches"] == 3
    assert_same_grids(got, want)
    filled = "filling" in port_out
    assert filled == ("filling" in gea_out) == (case == "d_threshold_fill")


def test_sample_writes_grids_and_gifs(runs, tmp_path):
    """Without capture: one PNG per stage and batch and, with --save_gif,
    one GIF per batch with a frame per stage, the frames of `gea`'s GIF
    within 1 level; the default output directory is samples_cli."""
    run = runs["glis"]
    gea_dir = str(tmp_path / "gea")
    jax_sample.main(["--load_path", run[0], "--save_path_samples", gea_dir, "--count", "4",
                     "--batch_size", "4", "--grid_rows", "2", "--save_gif"])
    sample.main(["--load_path", run[1], "--device", "cpu", "--count", "4", "--batch_size", "4",
                 "--grid_rows", "2", "--save_gif"], noise=jax_noise)
    port_dir = os.path.join(run[1], "samples_cli")
    names = sorted(os.listdir(port_dir))
    assert names == sorted(os.listdir(gea_dir)) == [
        "progression_00000000.gif", "samples_00000000_stage0.png", "samples_00000000_stage1.png"]
    for name in names:
        got, want = (Image.open(os.path.join(d, name)) for d in (port_dir, gea_dir))
        frames = [[np.asarray(f.convert("RGB"), np.int16) for f in ImageSequence.Iterator(im)]
                  for im in (got, want)]
        assert len(frames[0]) == len(frames[1]) == (2 if name.endswith(".gif") else 1)
        for a, b in zip(*frames):
            assert a.shape == b.shape == (34, 34, 3)
            assert np.abs(a - b).max() <= 1, name


def test_threshold_on_a_non_bce_run_warns(runs, tmp_path, capsys):
    """--d_threshold on a run trained with another --gan_loss prints
    `gea`'s warning; top-k does not."""
    run = str(tmp_path / "hinge")
    os.makedirs(run)
    cfg = TrainGLISConfig.load(os.path.join(runs["glis"][1], "config.json"))
    cfg.replace(gan_loss="hinge").save(os.path.join(run, "config.json"))
    os.symlink(os.path.join(runs["glis"][1], "checkpoints"), os.path.join(run, "checkpoints"))
    base = ["--load_path", run, "--device", "cpu", "--count", "4", "--batch_size", "4",
            "--d_filter"]
    sample.main(base)
    assert "warning" not in capsys.readouterr().out
    sample.main(base + ["--d_threshold", "0.5"])
    assert "warning: this run was trained with --gan_loss hinge" in capsys.readouterr().out


def test_sample_refuses(runs):
    with pytest.raises(SystemExit, match="--load_path is required"):
        sample.main(["--device", "cpu"])
    # --norm batch is ported: the sampler's config no longer refuses it.
    from gea_torch.config import SampleConfig, refuse_unported

    refuse_unported(SampleConfig(norm="batch"))


def test_read_run_points_gea_runs_to_the_converter(runs):
    with pytest.raises(FileNotFoundError, match="gea.cli.convert_checkpoint"):
        sample.read_run(runs["glis"][0])


# ----------------------------------------------------------- interpolations


def slerp_cases():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 1, 16)).astype(np.float32)
    b = rng.standard_normal((5, 1, 16)).astype(np.float32)
    near = (a * 2.0 + 1e-9).astype(np.float32)
    ortho = b - (b * a).sum(-1, keepdims=True) / (a * a).sum(-1, keepdims=True) * a
    # No antiparallel pair: there the dot product's last bit decides between
    # lerp and a division by sin(omega) ~ 3e-4, in either package.
    return {"random": (a, b), "parallel": (a, a * 3.0), "nearly_parallel": (a, near),
            "orthogonal": (a, ortho.astype(np.float32))}


@pytest.mark.parametrize("case", list(slerp_cases()))
def test_slerp_matches_gea(case):
    a, b = slerp_cases()[case]
    t = np.linspace(0.0, 1.0, 7, dtype=np.float32)
    want = np.asarray(jax_interp.slerp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(t)))
    got = sample_interpolations.slerp(torch.from_numpy(a), torch.from_numpy(b),
                                      torch.from_numpy(t)).numpy()
    assert got.shape == want.shape == (5, 7, 16) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(got[:, 0], a[:, 0], atol=ATOL)  # the walk starts at z_a


def read_png(path):
    return np.asarray(Image.open(path).convert("RGB"), np.int16)


@pytest.mark.parametrize("kind", ["glis", "glis_sc"])
@pytest.mark.parametrize("mode", ["slerp", "lerp"])
def test_interpolation_grids_match_gea(runs, kind, mode, tmp_path):
    """One grid per stage, one row of --interp_points frames per pair,
    within 1 level of `gea`'s; each pair's spatial noise is one draw."""
    args = ["--interp_pairs", "3", "--interp_points", "5", "--interp_mode", mode, "--seed", "4"]
    gea_dir, port_dir = str(tmp_path / "gea"), str(tmp_path / "port")
    jax_interp.main(["--load_path", runs[kind][0], "--save_path_samples", gea_dir] + args)
    images = sample_interpolations.main(["--load_path", runs[kind][1], "--device", "cpu",
                                         "--save_path_samples", port_dir] + args, pairs=jax_pairs)
    assert images.shape == (2, 15, 16, 16, 3)
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(gea_dir)) == [
        "interpolation_stage0.png", "interpolation_stage1.png"]
    for name in os.listdir(gea_dir):
        got, want = read_png(os.path.join(port_dir, name)), read_png(os.path.join(gea_dir, name))
        assert got.shape == want.shape == (3 * 18 - 2, 5 * 18 - 2, 3)
        assert np.abs(got - want).max() <= 1, name


# ---------------------------------------------------------------- R samplers

R_SEPARATE = {"default": [], "one_full_step": ["--correction_steps", "1",
                                               "--correction_strength", "0.5",
                                               "--shell_renorm", "false"]}


@pytest.mark.parametrize("case", list(R_SEPARATE))
def test_sample_r_separate_matches_gea(runs, case, monkeypatch, tmp_path):
    base = ["--count", "6", "--batch_size", "4", "--grid_rows", "2"] + R_SEPARATE[case]
    want = capture(monkeypatch, jax_rsep)
    jax_rsep.main(["--load_path", runs["rsep"][0], "--save_path_samples", str(tmp_path / "g")]
                  + base)
    got = capture(monkeypatch, sample_r_separate)
    sample_r_separate.main(["--load_path", runs["rsep"][1], "--device", "cpu",
                            "--save_path_samples", str(tmp_path / "p")] + base, noise=jax_noise)
    links = 2 if case == "one_full_step" else 3
    assert [g.shape[:2] for g in got] == [(links, 4), (links, 2)]
    assert_same_grids(got, want)


@pytest.mark.parametrize("links", [None, 3], ids=["trained_length", "extrapolated"])
def test_sample_r_iterative_matches_gea(runs, links, monkeypatch, tmp_path):
    base = ["--count", "6", "--batch_size", "4", "--grid_rows", "2"]
    base += [] if links is None else ["--chain_length", str(links)]
    want = capture(monkeypatch, jax_riter)
    jax_riter.main(["--load_path", runs["riter"][0], "--save_path_samples", str(tmp_path / "g")]
                   + base)
    got = capture(monkeypatch, sample_r_iterative)
    sample_r_iterative.main(["--load_path", runs["riter"][1], "--device", "cpu",
                             "--save_path_samples", str(tmp_path / "p")] + base, noise=jax_noise)
    assert [g.shape[:2] for g in got] == [((links or 2) + 1, 4), ((links or 2) + 1, 2)]
    assert_same_grids(got, want)


# --------------------------------------------------------------------- info


@pytest.mark.parametrize("kind", ["glis", "rsep", "riter"])
def test_info_matches_gea(runs, kind):
    want = jax_info.main(["--load_path", runs[kind][0]])
    got = info.main(["--load_path", runs[kind][1]])
    for key in ("params", "step", "checkpoint_steps", "best"):
        assert got.get(key) == want.get(key), key
    assert got["params"]["params_g" if kind != "rsep" else "params_r"] > 0
    assert got["config"]["image_size"] == want["config"]["image_size"] == 16


# ------------------------------------------------- flagship render golden

GOLDEN = ROOT / "tests" / "torch_port_render_golden.json"
RECIPE = {"config": "FLAGSHIP with dtype float32", "g_seed": 0, "d_seed": 0, "batch": 4,
          "z": "np.random.default_rng(7).standard_normal((4, 256)).astype(np.float32)",
          "pixels": "np.random.default_rng(5).integers(0, (80, 80, 3), size=(24, 3)): "
                    "(y, x, channel)"}
CPU_TOL = 1e-5


def golden_inputs():
    """(the fp32 flagship config, G's and D's params, z, the pixel
    positions), as RECIPE says."""
    cfg = FLAGSHIP.replace(dtype="float32")
    z = np.random.default_rng(7).standard_normal((4, cfg.code_size)).astype(np.float32)
    pixels = np.random.default_rng(5).integers(0, (80, 80, 3), size=(24, 3))
    return cfg, init_generator_params(cfg, 0), init_discriminator_params(cfg, 0), z, pixels


def golden_summary(images, logits, pixels) -> dict:
    """images (S, B, H, W, 3), logits (S, B) -> the golden's fields."""
    images = np.asarray(images, np.float64)
    y, x, c = pixels.T
    return {"mean": images.mean(axis=(2, 3, 4)).tolist(),
            "std": images.std(axis=(2, 3, 4)).tolist(),
            "pixels": images[:, :, y, x, c].tolist(),
            "d_logits": np.asarray(logits, np.float64).tolist()}


def gea_render():
    cfg, g, d, z, pixels = golden_inputs()
    jcfg = JaxModelConfig(**{k: getattr(cfg, k) for k in (
        "image_size", "code_size", "norm", "r_iterations", "num_features", "max_features",
        "dtype")})
    images, _ = JaxGeneratorLIS.from_config(jcfg).render({"params": g}, jnp.asarray(z))
    s, b = images.shape[:2]
    logits = JaxDiscriminator.from_config(jcfg).apply(
        {"params": d}, images.reshape(s * b, *images.shape[2:]), train=False)
    return golden_summary(np.asarray(images), np.asarray(logits).reshape(s, b), pixels)


def port_render():
    cfg, g, d, z, pixels = golden_inputs()
    generator = generator_from_jax_params(g, cfg, device="cpu")
    discriminator = discriminator_from_jax_params(d, cfg, device="cpu")
    with torch.no_grad():
        images = generator.render(torch.from_numpy(z))[0]
        s, b = images.shape[:2]
        logits = discriminator(images.reshape(s * b, *images.shape[2:])).reshape(s, b)
    return golden_summary(images.numpy(), logits.numpy(), pixels)


def write():
    jax.config.update("jax_default_matmul_precision", "highest")
    golden = {"recipe": RECIPE, "jax_version": jax.__version__, **gea_render()}
    GOLDEN.write_text(json.dumps(golden, indent=1) + "\n")
    print(f"wrote {GOLDEN}")


@pytest.mark.parametrize("render", [gea_render, port_render], ids=["gea", "port"])
def test_flagship_render_matches_the_golden(render):
    """Both packages' fp32 flagship render and D logits, on the CPU, within
    atol 1e-5 of the golden (`gea`'s own render checks the golden is still
    `gea`'s)."""
    golden = json.loads(GOLDEN.read_text())
    assert golden["recipe"] == RECIPE
    got = render()
    assert np.shape(got["pixels"]) == (4, 4, 24) and np.shape(got["d_logits"]) == (4, 4)
    for key in ("mean", "std", "pixels", "d_logits"):
        np.testing.assert_allclose(got[key], golden[key], atol=CPU_TOL, rtol=0, err_msg=key)


if __name__ == "__main__" and "--write" in sys.argv:
    write()
