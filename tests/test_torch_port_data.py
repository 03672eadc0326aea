"""The port's input pipeline (`gea_torch/data/`) and sample grids against
`gea`'s, on the CPU.

Datasets, the host preprocess and grid tiling must give the same bytes as
`gea`'s for the same arguments; the device preprocess agrees with `gea`'s
jitted `preprocess_batch` (`jax.image.resize`, bilinear, antialiased when
it shrinks) within 1e-6 for the same flip mask. Every stream restarts at
any batch: batch i is a pure function of (seed, i).
"""

import pickle
import threading
import time

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from gea.config import TrainGLISConfig as JaxTrainGLISConfig
from gea.data import hostpre as jax_hostpre
from gea.data import ondevice as jax_ondevice
from gea.data import pipeline as jax_pipeline
from gea.utils import grids as jax_grids
from gea_torch.config import TrainGLISConfig
from gea_torch.data import hostpre, ondevice, pipeline
from gea_torch.data.devicecache import device_cached_iterator
from gea_torch.data.prefetch import device_prefetch
from gea_torch.train.runner import input_iterator, make_input_fn
from gea_torch.utils import grids

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    """Results compared bit for bit are computed with one intra-op thread,
    so that every run takes the same path through torch's CPU kernels."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def img_dir(tmp_path_factory):
    """12 images: 6 PNGs of 40 x 48 and 6 JPEGs of 112 x 96, large enough
    that a decode to 32 takes PIL's reduced-scale JPEG path."""
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    for i in range(6):
        Image.fromarray((rng.random((48, 40, 3)) * 255).astype(np.uint8)).save(
            d / f"p{i:02d}.png")
        Image.fromarray((rng.random((96, 112, 3)) * 255).astype(np.uint8)).save(
            d / f"j{i:02d}.jpg", quality=90)
    return str(d)


@pytest.fixture(scope="module")
def cifar_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cifar")
    data = (np.random.default_rng(1).random((10, 3, 32, 32)) * 255).astype(np.uint8)
    with open(d / "data_batch_1", "wb") as f:
        pickle.dump({b"data": data.reshape(10, -1)}, f)
    return str(d)


def take(it, n):
    return [np.asarray(next(it)) for _ in range(n)]


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


def streams(kind, img_dir, cifar_dir):
    """(port dataset, gea dataset) built from the same arguments."""
    if kind == "synthetic":
        return (pipeline.SyntheticDataset(3, 16, seed=7),
                jax_pipeline.SyntheticDataset(3, 16, seed=7))
    if kind in ("folder", "cached"):
        args = (img_dir, 4, 80, 32)
        kw = dict(workers=2, seed=3)
        if kind == "folder":
            return pipeline.FolderDataset(*args, **kw), jax_pipeline.FolderDataset(*args, **kw)
        return (pipeline.CachedFolderDataset(*args, **kw),
                jax_pipeline.CachedFolderDataset(*args, **kw))
    kw = dict(dataset="cifar10", dataroot=cifar_dir, batch_size=3, crop_size=32, image_size=32)
    return (pipeline.make_dataset(TrainGLISConfig(**kw), seed=5),
            jax_pipeline.make_dataset(JaxTrainGLISConfig(**kw), seed=5))


KINDS = ["synthetic", "folder", "cached", "cifar10"]


@pytest.mark.parametrize("kind", KINDS)
def test_dataset_bytes_match_gea(kind, img_dir, cifar_dir):
    """8 batches, across epoch boundaries for the shuffled datasets (12
    images in batches of 4; 10 CIFAR images in batches of 3)."""
    port, ref = streams(kind, img_dir, cifar_dir)
    assert len(port) == len(ref)
    assert_batches_equal(take(port.batches(0), 8), take(ref.batches(0), 8))


@pytest.mark.parametrize("kind", KINDS)
def test_dataset_restarts_at_any_batch(kind, img_dir, cifar_dir):
    port, _ = streams(kind, img_dir, cifar_dir)
    full = take(port.batches(0), 8)
    assert_batches_equal(take(port.batches(5), 3), full[5:])


def test_make_dataset_refuses_what_is_not_ported(img_dir):
    """grain and LSUN (the native backend is ported: its cases are in
    test_torch_port_native_loader.py)."""
    with pytest.raises(ValueError, match="not ported"):
        pipeline.make_dataset(TrainGLISConfig(dataset="folder", dataroot=img_dir,
                                              batch_size=4, data_backend="grain"))
    with pytest.raises(ValueError, match="not ported"):
        pipeline.make_dataset(TrainGLISConfig(dataset="lsun", dataroot=img_dir))
    with pytest.raises(ValueError, match="batch_size"):
        pipeline.make_dataset(TrainGLISConfig(dataset="folder", dataroot=img_dir,
                                              batch_size=64))


@pytest.mark.parametrize("crop,image", [(160, 80), (96, 80), (64, 64)])
@pytest.mark.parametrize("augment_flip", [True, False])
def test_preprocess_matches_gea(crop, image, augment_flip):
    """Center crop of a (6, crop + 6, crop + 4) batch, resize, flip and
    normalise, against `gea`'s with the flip mask that `gea` draws."""
    b = 6
    raw = (np.random.default_rng(crop).random((b, crop + 6, crop + 4, 3)) * 255).astype(np.uint8)
    rng = jax.random.PRNGKey(crop + image)
    want = np.asarray(jax_ondevice.preprocess_batch(
        raw, rng, crop_size=crop, image_size=image, augment_flip=augment_flip))
    flip = np.array(jax.random.bernoulli(rng, 0.5, (b, 1, 1, 1))).reshape(b)
    assert 0 < flip.sum() < b
    got = ondevice.preprocess_batch(torch.from_numpy(raw), crop, image, augment_flip,
                                    flip=torch.from_numpy(flip))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_preprocess_draws_its_mask_from_the_generator():
    raw = torch.from_numpy((np.random.default_rng(0).random((8, 20, 20, 3)) * 255)
                           .astype(np.uint8))
    outs = [ondevice.preprocess_batch(raw, 20, 20, gen=torch.Generator().manual_seed(s))
            for s in (1, 1, 2)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert not torch.equal(outs[0], outs[2])
    flip = ondevice.flip_mask(torch.Generator().manual_seed(1), 8)
    want = torch.where(flip.view(8, 1, 1, 1), raw.flip(2), raw).float() / 127.5 - 1
    torch.testing.assert_close(outs[0], want, rtol=0, atol=0)


def test_synthetic_batch_shape_range_and_seed():
    gen = torch.Generator()
    a = ondevice.synthetic_batch(gen.manual_seed(3), 5, 24)
    b = ondevice.synthetic_batch(gen.manual_seed(3), 5, 24)
    c = ondevice.synthetic_batch(gen.manual_seed(4), 5, 24)
    assert a.shape == (5, 24, 24, 3) and a.dtype == torch.float32
    assert a.min() >= -1 and a.max() <= 1 and a.std() > 0.3
    assert torch.equal(a, b) and not torch.equal(a, c)
    # The family of SyntheticDataset: 0.5 + 0.5 sin(...) + U(0, 0.1), clipped.
    host = next(pipeline.SyntheticDataset(5, 24, seed=0).batches()) / 127.5 - 1
    assert abs(float(a.mean()) - float(host.mean())) < 0.2


@pytest.mark.parametrize("crop,image", [(160, 80), (96, 32), (100, 80), (32, 32)])
def test_host_preprocess_matches_gea(crop, image):
    raw = (np.random.default_rng(image).random((5, crop + 2, crop, 3)) * 255).astype(np.uint8)
    got = hostpre.host_preprocess(raw, np.random.default_rng(9), crop, image)
    want = jax_hostpre.host_preprocess(raw, np.random.default_rng(9), crop, image)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(hostpre.host_downsample_uint8(raw, crop, image),
                                  jax_hostpre.host_downsample_uint8(raw, crop, image))


def folder_cfg(img_dir, **kw):
    base = dict(dataset="folder", dataroot=img_dir, crop_size=80, image_size=16,
                batch_size=4, seed=3, device="cpu")
    return TrainGLISConfig(**{**base, **kw})


def test_device_cache_serves_the_streaming_bytes(img_dir):
    """The resident dataset's gathered batches equal the host cache's
    stream byte for byte, across an epoch, and restart at any step."""
    cfg = folder_cfg(img_dir)
    host = pipeline.make_dataset(cfg.replace(data_cache=True), seed=cfg.seed)
    want = take(host.batches(0), 8)
    assert_batches_equal(take(device_cached_iterator(cfg, CPU, cfg.seed), 8), want)
    assert_batches_equal(take(device_cached_iterator(cfg, CPU, cfg.seed, start_step=5), 3),
                         want[5:])
    with pytest.raises(ValueError, match="on_device_pipeline"):
        device_cached_iterator(cfg.replace(on_device_pipeline=False), CPU, cfg.seed)
    with pytest.raises(ValueError, match="single-host"):
        device_cached_iterator(cfg.replace(multihost=True), CPU, cfg.seed)


@pytest.mark.parametrize("kw", [
    {"dataset": "synthetic"},
    {"dataset": "synthetic", "synthetic_on_device": True},
    {"dataset": "synthetic", "on_device_pipeline": False},
    {"dataset": "synthetic", "host_resize": True},
    {"device_data_cache": True},
    {"data_cache": True},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_input_path_fast_forwards(img_dir, kw):
    """The real batches of steps 4 and 5 of a stream started at 0 equal
    those of a stream started at 4: the data and the flip mask are keyed
    by the step."""
    cfg = folder_cfg(img_dir, **kw)
    make_real = make_input_fn(cfg, CPU)

    def reals(start, n):
        it = input_iterator(cfg, CPU, cfg.seed, start_step=start)
        out = [make_real(next(it), step) for step in range(start, start + n)]
        it.close()
        return out

    full, tail = reals(0, 6), reals(4, 2)
    for a, b in zip(full[4:], tail):
        assert a.shape == (4, 16, 16, 3) and a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(full[0], full[1])


def test_prefetch_finite_stream():
    out = list(device_prefetch((np.full((2, 4, 4, 3), i, np.uint8) for i in range(3)), CPU))
    assert [int(t[0, 0, 0, 0]) for t in out] == [0, 1, 2]
    assert all(isinstance(t, torch.Tensor) for t in out)


def test_prefetch_worker_error_reaches_consumer():
    def broken():
        yield np.zeros((2, 4, 4, 3), np.uint8)
        raise OSError("unreadable image")

    it = device_prefetch(broken(), CPU)
    next(it)
    with pytest.raises(RuntimeError, match="input pipeline worker failed") as info:
        next(it)
    assert isinstance(info.value.__cause__, OSError)


def test_prefetch_abandoned_iterator_thread_exits():
    def endless():
        while True:
            yield np.zeros((2, 4, 4, 3), np.uint8)

    before = threading.active_count()
    it = device_prefetch(endless(), CPU, depth=1)
    next(it)
    it.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


@pytest.mark.parametrize("b,rows", [(4, 2), (6, 2), (9, 3), (5, 1)])
def test_tile_grid_and_png_match_gea(tmp_path, b, rows):
    images = np.random.default_rng(b).uniform(-1, 1, (b, 7, 5, 3)).astype(np.float32)
    got = grids.tile_grid(grids.to_uint8(images), rows)
    np.testing.assert_array_equal(got, jax_grids.tile_grid(jax_grids.to_uint8(images), rows))
    path = tmp_path / "grid.png"
    grids.save_image_grid(images, str(path), rows=rows)
    with Image.open(path) as im:
        assert im.format == "PNG" and im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), got)


def test_stage_grids_and_gif(tmp_path):
    stages = np.random.default_rng(0).uniform(-1, 1, (3, 4, 8, 8, 3)).astype(np.float32)
    grids.save_stage_grids(stages, str(tmp_path), step=12, rows=2)
    for s in range(3):
        with Image.open(tmp_path / f"samples_00000012_stage{s}.png") as im:
            np.testing.assert_array_equal(
                np.asarray(im), grids.tile_grid(grids.to_uint8(stages[s]), 2))
    grids.save_stage_gif(stages, str(tmp_path / "stages.gif"), rows=2)
    with Image.open(tmp_path / "stages.gif") as im:
        assert im.n_frames == 3
