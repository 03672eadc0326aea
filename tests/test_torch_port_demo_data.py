"""The port's demo-data generator (`gea_torch/cli/make_demo_data.py`)
against `gea`'s (`gea/cli/make_demo_data.py`) on the CPU.

Both draw from `np.random.default_rng(--seed)` with numpy and encode with
PIL, so the check is exact: the same arrays, the same rng state after each
image, the same JPEG bytes, and the same MANIFEST.json apart from the
command's module name.
"""

import hashlib
import json
import os

import numpy as np
import pytest

from gea.cli import make_demo_data as jax_demo
from gea_torch.cli import make_demo_data as demo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST = os.path.join(ROOT, "data", "demo20k", "MANIFEST.json")
STYLES = sorted(demo.RENDERERS)
FIRST = 8


@pytest.mark.parametrize("style", STYLES)
def test_renderers_draw_geas_arrays(style):
    """The first FIRST images of a style, rendered one after another from
    one rng, equal `gea`'s, and each leaves the rng where `gea`'s does."""
    ours, theirs = np.random.default_rng(3), np.random.default_rng(3)
    for i in range(FIRST):
        got = demo.RENDERERS[style](ours, 64)
        want = jax_demo.RENDERERS[style](theirs, 64)
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (64, 64, 3)
        np.testing.assert_array_equal(got, want, err_msg=f"{style} image {i}")
        assert ours.bit_generator.state == theirs.bit_generator.state, f"{style} image {i}"


def _files(folder):
    return {name: open(os.path.join(folder, name), "rb").read()
            for name in sorted(os.listdir(folder)) if name.endswith(".jpg")}


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """The first FIRST images of both styles at the manifest's settings,
    written by each package: {(package, style): folder}."""
    out = {}
    for style in STYLES:
        for name, mod in (("gea", jax_demo), ("port", demo)):
            folder = str(tmp_path_factory.mktemp(f"{name}_{style}"))
            mod.main(["--out", folder, "--count", str(FIRST), "--size", "200", "--seed", "0",
                      "--quality", "92", "--style", style])
            out[name, style] = folder
    return out


@pytest.mark.parametrize("style", STYLES)
def test_main_writes_geas_jpeg_bytes(dumps, style):
    got, want = _files(dumps["port", style]), _files(dumps["gea", style])
    assert list(got) == [f"img{i:05d}.jpg" for i in range(FIRST)] == list(want)
    for name in want:
        assert got[name] == want[name], f"{style} {name}"


@pytest.mark.parametrize("style", STYLES)
def test_manifest_equals_geas_but_the_command(dumps, style):
    got, want = (json.load(open(os.path.join(dumps[k, style], "MANIFEST.json")))
                 for k in ("port", "gea"))
    assert got["command"].startswith("python -m gea_torch.cli.make_demo_data --out ")
    assert got.pop("command").split(" --count")[1] == want.pop("command").split(" --count")[1]
    assert got == want


@pytest.mark.parametrize("style", STYLES)
def test_manifest_only_rehashes_the_folder(dumps, style, tmp_path):
    """--manifest_only hashes the files already in --out into the same
    manifest as the one written with them, and writes no image."""
    folder = str(tmp_path / "copy")
    os.makedirs(folder)
    for name, data in _files(dumps["port", style]).items():
        with open(os.path.join(folder, name), "wb") as f:
            f.write(data)
    demo.main(["--out", folder, "--count", str(FIRST), "--size", "200", "--seed", "0",
               "--quality", "92", "--style", style, "--manifest_only"])
    assert sorted(os.listdir(folder)) == sorted(["MANIFEST.json", *_files(folder)])
    got = json.load(open(os.path.join(folder, "MANIFEST.json")))
    want = json.load(open(os.path.join(dumps["port", style], "MANIFEST.json")))
    assert got.pop("command").replace(folder, "X") == want.pop("command").replace(
        dumps["port", style], "X")
    assert got == want


def test_first_image_matches_the_committed_manifest(dumps):
    """img00000.jpg of demo20k has the committed spot hash wherever pillow
    and libjpeg are the manifest's (they decide the JPEG bytes)."""
    manifest = json.load(open(MANIFEST))
    versions = demo.library_versions()
    if any(versions[k] != manifest["versions"][k] for k in ("pillow", "libjpeg")):
        pytest.skip(f"pillow/libjpeg {versions} differ from the manifest's "
                    f"{manifest['versions']}: the JPEG bytes may differ")
    data = _files(dumps["port", "diverse"])["img00000.jpg"]
    assert hashlib.sha256(data).hexdigest() == manifest["sha256_spot_check"]["img00000.jpg"]
