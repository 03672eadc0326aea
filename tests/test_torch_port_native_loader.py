"""The port's native C++ JPEG loader (`gea_torch/data/native_build.py`,
`native_loader.py`, `csrc/loader.cpp`) against `gea`'s
(`gea/data/native_build.py`, `native_loader.py`, `native/loader.cpp`), on
the CPU.

The port keeps a byte-for-byte copy of `gea`'s source and builds it with
`gea`'s command into its own `build/` tree. On an all-JPEG folder both
packages' `--data_backend auto` and `native` streams and `--data_cache`
decodes take the native path, and their batches are equal bit for bit,
order and pixels, from batch 0 and from a restart, across epoch
boundaries. Skipped, with the reason, only where g++ or libjpeg's header
is missing.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from gea.config import TrainGLISConfig as JaxTrainGLISConfig
from gea.data import native_loader as jax_native_loader
from gea.data import pipeline as jax_pipeline
from gea_torch.config import TrainGLISConfig
from gea_torch.data import native_build, native_loader, pipeline

ROOT = Path(__file__).resolve().parent.parent

if shutil.which("g++") is None or not os.path.exists("/usr/include/jpeglib.h"):
    pytest.skip("the native loader needs g++ and libjpeg's headers", allow_module_level=True)


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """10 smooth and 10 noise JPEGs of 160 x 176 (an all-JPEG folder), and
    a folder with one PNG among them."""
    d = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:160, 0:176].astype(np.float32)
    for i in range(10):
        smooth = np.stack([yy / 160 * 255, xx / 176 * 255,
                           np.full_like(yy, 20 * i)], -1).astype(np.uint8)
        Image.fromarray(smooth).save(d / f"s{i:02d}.jpg", quality=92)
        noise = (rng.random((160, 176, 3)) * 255).astype(np.uint8)
        Image.fromarray(noise).save(d / f"n{i:02d}.jpeg", quality=90)
    mixed = tmp_path_factory.mktemp("mixed")
    for p in sorted(d.iterdir())[:8]:
        shutil.copy(p, mixed / p.name)
    Image.fromarray((rng.random((40, 48, 3)) * 255).astype(np.uint8)).save(mixed / "p.png")
    return {"jpeg": str(d), "mixed": str(mixed)}


def test_source_is_geas_byte_for_byte():
    port = (ROOT / "gea_torch" / "csrc" / "loader.cpp").read_bytes()
    assert port == (ROOT / "gea" / "data" / "native" / "loader.cpp").read_bytes()


def test_library_is_built_under_build_not_gea():
    assert native_loader.native_available()
    path = native_build.library_path()
    assert path.exists()
    assert path.parent == ROOT / "build" / "gea_torch_loader"
    assert ROOT / "gea" not in path.parents


def test_import_builds_nothing(tmp_path):
    """A fresh interpreter that imports the port (and its data modules)
    with an empty build directory builds no loader."""
    code = (
        "import sys; sys.path.insert(0, %r);"
        "from gea_torch.data import native_build as nb;"
        "nb.BUILD_DIR = __import__('pathlib').Path(%r);"
        "import gea_torch, gea_torch.data.pipeline, gea_torch.data.native_loader;"
        "from gea_torch.cli import train_glis;"
        "assert nb._lib is None and not nb._tried and not nb.BUILD_DIR.exists()"
    ) % (str(ROOT), str(tmp_path / "nothing"))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


@pytest.mark.parametrize("kind", ["smooth", "noise"])
@pytest.mark.parametrize("crop,out", [(160, 80), (160, 64), (64, 64)])
def test_decode_square_equals_geas(jpegs, kind, crop, out):
    for i in range(3):
        ext = "jpg" if kind == "smooth" else "jpeg"
        path = os.path.join(jpegs["jpeg"], f"{kind[0]}{i:02d}.{ext}")
        got = native_loader.decode_square(path, crop, out)
        assert got.shape == (out, out, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, jax_native_loader.decode_square(path, crop, out))


def paths(folder):
    return pipeline.list_images(folder)


@pytest.mark.parametrize("start", [0, 5])
def test_native_folder_loader_equals_geas(jpegs, start):
    """20 images in batches of 6: batches 0..7 (or 5..7) cross epoch
    boundaries (the pool's batches run across them)."""
    args = (paths(jpegs["jpeg"]), 6, 120, 64)
    port = native_loader.NativeFolderLoader(*args, workers=3, seed=11)
    ref = jax_native_loader.NativeFolderLoader(*args, workers=3, seed=11)
    try:
        got, want = port.batches(start), ref.batches(start)
        for _ in range(8 - start):
            np.testing.assert_array_equal(next(got), next(want))
    finally:
        port.close()
        ref.close()


def test_restart_at_another_batch_is_refused(jpegs):
    loader = native_loader.NativeFolderLoader(paths(jpegs["jpeg"]), 4, 120, 64, workers=2)
    try:
        next(loader.batches(0))
        with pytest.raises(ValueError, match="cannot restart at 3"):
            next(loader.batches(3))
    finally:
        loader.close()


def configs(folder, **kw):
    kw = {**dict(dataset="folder", dataroot=folder, batch_size=6, crop_size=120, image_size=64,
                 data_workers=2), **kw}
    return TrainGLISConfig(**kw), JaxTrainGLISConfig(**kw)


@pytest.mark.parametrize("backend,cache", [("auto", False), ("native", False),
                                           ("auto", True), ("native", True)])
def test_make_dataset_equals_geas_on_an_all_jpeg_folder(jpegs, backend, cache):
    """The missing cases of test_dataset_bytes_match_gea: `gea`'s side as
    `gea` runs it (its native path where its library builds), 8 batches."""
    pcfg, jcfg = configs(jpegs["jpeg"], data_backend=backend, data_cache=cache)
    port, ref = pipeline.make_dataset(pcfg, seed=3), jax_pipeline.make_dataset(jcfg, seed=3)
    assert pipeline.backend_of(port) == "native"
    assert type(port).__name__ == type(ref).__name__
    got, want = port.batches(0), ref.batches(0)
    for _ in range(8):
        np.testing.assert_array_equal(np.asarray(next(got)), np.asarray(next(want)))


def test_auto_on_a_mixed_folder_is_pil_and_native_raises(jpegs):
    pcfg, jcfg = configs(jpegs["mixed"], batch_size=4)
    port = pipeline.make_dataset(pcfg, seed=1)
    assert pipeline.backend_of(port) == "pil"
    np.testing.assert_array_equal(next(port.batches(0)),
                                  next(jax_pipeline.make_dataset(jcfg, seed=1).batches(0)))
    pcfg, jcfg = configs(jpegs["mixed"], batch_size=4, data_backend="native")
    with pytest.raises(RuntimeError) as want:
        jax_pipeline.make_dataset(jcfg, seed=1)
    with pytest.raises(RuntimeError) as got:
        pipeline.make_dataset(pcfg, seed=1)
    assert str(got.value) == str(want.value)


def test_ranks_take_their_own_seed(jpegs):
    """Under --num_devices N each rank's native stream is seeded seed +
    7919 * rank (`runner.rank_data`), as `gea`'s processes are."""
    from gea_torch.train.runner import rank_data

    class Rank:
        size, rank = 2, 1

    pcfg, _ = configs(jpegs["jpeg"], data_backend="native")
    cfg, seed = rank_data(pcfg, 5, Rank())
    assert (cfg.batch_size, seed) == (3, 5 + 7919)
    got = pipeline.make_dataset(cfg, seed=seed)
    want = jax_native_loader.NativeFolderLoader(paths(jpegs["jpeg"]), 3, 120, 120, workers=2,
                                                seed=5 + 7919)
    try:
        np.testing.assert_array_equal(next(got.batches(0)), next(want.batches(0)))
    finally:
        got.close()
        want.close()
