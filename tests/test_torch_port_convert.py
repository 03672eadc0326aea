"""The bridge between `gea` and the port (`gea_torch/cli/convert_checkpoint.py`
against `gea/cli/convert_checkpoint.py`), on the CPU at a tiny config.

The run directories are `test_torch_port_samplers.py`'s: each package's
G-LIS (with an EMA shadow), R-separate and R-iterative runs holding the
same weights. Checked in both directions:

* a `gea` run -> `gea.cli.convert_checkpoint` -> the port's `--from_torch`
  -> the port's sampler gives `gea.cli`'s sampler's images (atol 1e-5);
* a port run -> the port's export -> `gea`'s `import_torch` -> `gea.cli`'s
  sampler gives the port's sampler's images (atol 1e-5);
* the port's export holds exactly the tensors of `gea`'s export of the
  same weights, and export -> import in the port is bitwise.
"""

import os

import pytest
import torch

from gea.cli import convert_checkpoint as jax_convert
from gea.cli import sample as jax_sample
from gea.cli import sample_r_iterative as jax_riter
from gea_torch.cli import convert_checkpoint, info, sample, sample_r_iterative
from test_torch_port_samplers import (  # noqa: F401 (runs: the shared run directories)
    assert_same_grids,
    capture,
    jax_noise,
    runs,
)

MODULES = ("generator", "discriminator", "reverter")
# kind -> (the run, export flags, the modules the export holds)
KINDS = {
    "glis": ("glis", [], ("discriminator", "generator")),
    "glis_ema": ("glis", ["--use_ema"], ("discriminator", "generator")),
    "rsep": ("rsep", [], ("reverter",)),
    "riter": ("riter", [], ("discriminator", "generator", "reverter")),
}
SAMPLE_ARGS = ["--count", "6", "--batch_size", "4", "--grid_rows", "2"]


def export(package, run, out, flags=()):
    mod = jax_convert if package == "gea" else convert_checkpoint
    mod.main(["--load_path", run, "--out", out, *flags])
    return torch.load(out, map_location="cpu", weights_only=False)


def render(package, kind, run, monkeypatch, tmp_path, extra=()):
    """The stage images of `package`'s sampler for `kind` on `run`."""
    out = str(tmp_path / f"{package}_{os.path.basename(run)}_samples")
    args = ["--load_path", run, "--save_path_samples", out, *SAMPLE_ARGS, *extra]
    if kind == "riter":
        mod = jax_riter if package == "gea" else sample_r_iterative
    else:
        mod = jax_sample if package == "gea" else sample
    grids = capture(monkeypatch, mod)
    if package == "gea":
        mod.main(args)
    else:
        mod.main(args + ["--device", "cpu"], noise=jax_noise)
    return grids


@pytest.mark.parametrize("kind", list(KINDS))
def test_export_holds_geas_tensors(runs, kind, tmp_path, capsys):
    run, flags, modules = KINDS[kind]
    want = export("gea", runs[run][0], str(tmp_path / "gea.pt"), flags)
    got = export("port", runs[run][1], str(tmp_path / "port.pt"), flags)
    assert got["format"] == want["format"] == "gea-torch-v1"
    assert got["step"] == want["step"]
    assert tuple(sorted(k for k in MODULES if k in got)) == modules
    assert tuple(sorted(k for k in MODULES if k in want)) == modules
    for name in modules:
        assert got[name].keys() == want[name].keys(), name
        for key, t in want[name].items():
            assert torch.equal(got[name][key], t), f"{name}.{key}"
    assert {k: got["config"][k] for k in ("image_size", "code_size", "r_iterations")} == {
        k: want["config"][k] for k in ("image_size", "code_size", "r_iterations")}
    if kind == "rsep":
        assert "note: R-separate runs hold only the reverter" in capsys.readouterr().out


@pytest.mark.parametrize("kind", ["glis", "glis_ema", "riter"])
def test_gea_run_imported_renders_geas_images(runs, kind, monkeypatch, tmp_path):
    """gea run -> gea export -> port import -> port sampler == gea sampler."""
    run, flags, _ = KINDS[kind]
    f = str(tmp_path / "gea.pt")
    export("gea", runs[run][0], f, flags)
    imported = str(tmp_path / "imported")
    convert_checkpoint.main(["--from_torch", f, "--out_run", imported])
    want = render("gea", kind, runs[run][0], monkeypatch, tmp_path, flags)
    got = render("port", kind, imported, monkeypatch, tmp_path)
    assert_same_grids(got, want)


@pytest.mark.parametrize("kind", ["glis", "glis_ema", "riter"])
def test_port_run_imported_into_gea_renders_the_ports_images(runs, kind, monkeypatch, tmp_path):
    """port run -> port export -> gea import -> gea sampler == port sampler."""
    run, flags, _ = KINDS[kind]
    f = str(tmp_path / "port.pt")
    export("port", runs[run][1], f, flags)
    imported = str(tmp_path / "gea_imported")
    jax_convert.main(["--from_torch", f, "--out_run", imported])
    want = render("port", kind, runs[run][1], monkeypatch, tmp_path, flags)
    got = render("gea", kind, imported, monkeypatch, tmp_path)
    assert_same_grids(got, want)


@pytest.mark.parametrize("kind", list(KINDS))
def test_port_round_trip_is_bitwise(runs, kind, tmp_path):
    """Export -> import in the port: the imported checkpoint holds the
    run's module tensors bit for bit (G's EMA shadow with --use_ema), at
    the run's step, and `info` counts the same parameters."""
    run, flags, modules = KINDS[kind]
    src = runs[run][1]
    f = str(tmp_path / "port.pt")
    payload = export("port", src, f, flags)
    imported = str(tmp_path / "imported")
    convert_checkpoint.main(["--from_torch", f, "--out_run", imported])
    _, want = sample.read_run(src)
    _, got = sample.read_run(imported)
    assert got["step"] == want["step"] == payload["step"]
    assert sorted(k for k in MODULES if k in got) == list(modules)
    for name in modules:
        ref = dict(want[name])
        if name == "generator" and flags:
            ref.update(want["g_ema"])
        assert got[name].keys() == ref.keys()
        for key, t in ref.items():
            assert torch.equal(got[name][key], t), f"{name}.{key}"
    assert info.summarize(imported)["params"] == info.summarize(src)["params"]


def test_import_at_another_step(runs, tmp_path):
    f = str(tmp_path / "port.pt")
    export("port", runs["glis"][1], f)
    out = str(tmp_path / "at7")
    convert_checkpoint.main(["--from_torch", f, "--out_run", out, "--step", "7"])
    assert info.summarize(out)["checkpoint_steps"] == [7]


def test_convert_refuses(runs, tmp_path):
    f = str(tmp_path / "port.pt")
    export("port", runs["glis"][1], f)
    with pytest.raises(SystemExit, match="only valid for export"):
        convert_checkpoint.main(["--from_torch", f, "--out_run", str(tmp_path / "x"),
                                 "--step", "-1"])
    with pytest.raises(SystemExit, match="requires --out_run"):
        convert_checkpoint.main(["--from_torch", f])
    with pytest.raises(SystemExit, match="requires --load_path and --out"):
        convert_checkpoint.main(["--load_path", runs["glis"][1]])
    with pytest.raises(SystemExit, match="no EMA params"):
        convert_checkpoint.main(["--load_path", runs["riter"][1], "--out", f, "--use_ema"])
    bad = str(tmp_path / "bad.pt")
    torch.save({"format": "other"}, bad)
    with pytest.raises(SystemExit, match="not a gea-torch-v1 export"):
        convert_checkpoint.main(["--from_torch", bad, "--out_run", str(tmp_path / "y")])
