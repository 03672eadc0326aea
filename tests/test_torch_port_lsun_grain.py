"""The port's LSUN reader (`gea_torch.data.lsun`) and grain loader
(`gea_torch.data.grain_loader`) against `gea`'s, on the CPU.

LSUN: a plain class folder, several classes (a symlink farm) and a missing
class resolve as `gea`'s `resolve_lsun_root` resolves them; an LMDB export
through a fake `lmdb` module (put in `sys.modules`) writes the files,
names and marker of `gea`'s export byte for byte, a second export is
skipped on the marker, a 0-image export raises and writes no marker, and
without `lmdb` the export raises `gea`'s message. `list_images` follows
a farm's symlinks (`gea`'s does not, and finds no images there), each
real folder once, and outside a farm lists as `gea`'s.

grain: the port's batches equal `gea`'s `GrainFolderLoader`'s bit for bit,
from batch 0 across an epoch boundary and from batch 3; the trainer picks
the loader with `--data_backend grain` and trains on it; `import gea_torch`
and the loader's module load no JAX (grain is imported by the loader
only), and no port file imports grain or lmdb at module level.
"""

import ast
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
from PIL import Image

from gea.data import lsun as jax_lsun
from gea.data.grain_loader import GrainFolderLoader as JaxGrainFolderLoader
from gea_torch.cli import train_glis
from gea_torch.config import TrainGLISConfig
from gea_torch.data import lsun, pipeline
from gea_torch.data.grain_loader import GrainFolderLoader

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def root(tmp_path):
    """Two plain class folders of JPEGs (church 5, tower 3) and an LMDB
    class directory (bedroom_train_lmdb/data.mdb)."""
    rng = np.random.default_rng(0)
    for cls, n in (("church", 5), ("tower", 3)):
        (tmp_path / cls).mkdir()
        for i in range(n):
            Image.fromarray((rng.random((40, 48, 3)) * 255).astype(np.uint8)).save(
                tmp_path / cls / f"{cls}{i}.jpg", quality=90)
    (tmp_path / "bedroom_train_lmdb").mkdir()
    (tmp_path / "bedroom_train_lmdb" / "data.mdb").write_bytes(b"")
    return tmp_path


def cfg(root, classes):
    return TrainGLISConfig(dataset="lsun", dataroot=str(root), lsun_classes=classes)


def tree(path) -> dict:
    """Every file under `path` (links followed) -> its bytes; links -> their
    targets' names."""
    out = {}
    for dirpath, _, files in os.walk(path, followlinks=True):
        for fn in files:
            p = os.path.join(dirpath, fn)
            out[os.path.relpath(p, path)] = open(p, "rb").read()
    return out


@pytest.mark.parametrize("classes", ["church", "tower,church", "church, tower,"])
def test_resolve_lsun_root_is_geas(root, classes):
    got = lsun.resolve_lsun_root(cfg(root, classes))
    want = jax_lsun.resolve_lsun_root(cfg(root, classes))
    assert got == want
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    if "," in classes:
        assert got == str(root / "_lsun_church_tower")
        assert sorted(os.readlink(os.path.join(got, c)) for c in os.listdir(got)) == [
            str(root / "church"), str(root / "tower")]


def test_farm_images_are_listed_through_its_links(root):
    farm = lsun.resolve_lsun_root(cfg(root, "tower,church"))
    assert len(pipeline.list_images(farm)) == 8
    with pytest.raises(FileNotFoundError, match="no images found"):
        from gea.data.pipeline import list_images as jax_list_images

        jax_list_images(farm)  # gea's walk does not follow the links


def test_a_plain_folder_lists_as_geas(root):
    """Outside a farm a symlinked folder is not followed, as in `gea`."""
    from gea.data.pipeline import list_images as jax_list_images

    os.symlink(root / "church", root / "tower" / "church_link")
    assert pipeline.list_images(str(root / "tower")) == jax_list_images(str(root / "tower"))
    assert len(pipeline.list_images(str(root / "tower"))) == 3


def test_a_cycle_of_links_in_a_farm_ends(root):
    farm = lsun.resolve_lsun_root(cfg(root, "tower,church"))
    os.symlink(farm, root / "church" / "back_to_farm")
    os.symlink(root / "church", root / "church" / "itself")
    paths = pipeline.list_images(farm)
    assert len(paths) == 8 and len({os.path.realpath(p) for p in paths}) == 8


@pytest.mark.parametrize("classes", ["kitchen", "church,kitchen", ""])
def test_missing_classes_raise_as_geas(root, classes):
    errors = []
    for mod in (lsun, jax_lsun):
        with pytest.raises((FileNotFoundError, ValueError)) as e:
            mod.resolve_lsun_root(cfg(root, classes))
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]


def fake_lmdb(blobs):
    """A stand-in `lmdb` module whose one environment holds `blobs`
    ((key, value) pairs)."""
    class Txn:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def cursor(self):
            return iter(blobs)

    class Env:
        def begin(self, write=False):
            return Txn()

        def close(self):
            pass

    return types.SimpleNamespace(open=lambda *a, **kw: Env())


BLOBS = [(b"0001", b"RIFF\x10\x00\x00\x00WEBPVP8 fake"), (b"k" * 80, b"\xff\xd8\xff\xe0 jpeg"),
         (b"caf\xc3\xa9", b"\xff\xd8 another")]


@pytest.mark.parametrize("limit", [0, 2])
def test_export_is_byte_for_byte_geas(root, tmp_path_factory, monkeypatch, limit):
    monkeypatch.setitem(sys.modules, "lmdb", fake_lmdb(BLOBS))
    other = tmp_path_factory.mktemp("gea_root")
    (other / "bedroom_train_lmdb").mkdir()
    (other / "bedroom_train_lmdb" / "data.mdb").write_bytes(b"")
    got = lsun.export_class(str(root), "bedroom", limit)
    want = jax_lsun.export_class(str(other), "bedroom", limit)
    assert os.path.basename(got) == os.path.basename(want) == "bedroom_train_images"
    assert tree(got) == tree(want)
    assert len(tree(got)) == (limit or len(BLOBS)) + 1  # and the marker
    monkeypatch.setitem(sys.modules, "lmdb", fake_lmdb([]))
    assert lsun.export_class(str(root), "bedroom") == got  # skipped on the marker


def test_empty_export_raises_and_writes_no_marker(root, monkeypatch):
    monkeypatch.setitem(sys.modules, "lmdb", fake_lmdb([]))
    with pytest.raises(ValueError, match="produced 0 images"):
        lsun.export_class(str(root), "bedroom")
    assert not os.path.exists(root / "bedroom_train_images" / ".complete")


def test_export_without_lmdb_raises_geas_message(root, monkeypatch):
    monkeypatch.setitem(sys.modules, "lmdb", None)  # import lmdb raises ImportError
    errors = []
    for mod in (lsun, jax_lsun):
        with pytest.raises(RuntimeError) as e:
            mod.resolve_lsun_root(cfg(root, "bedroom"))
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "needs the 'lmdb' package" in errors[0]


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """10 JPEGs and 3 PNGs of assorted sizes."""
    d = tmp_path_factory.mktemp("grain")
    rng = np.random.default_rng(1)
    for i in range(13):
        h, w = 40 + 8 * (i % 3), 48 + 4 * (i % 4)
        img = Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8))
        img.save(d / (f"i{i:02d}.jpg" if i < 10 else f"i{i:02d}.png"))
    return str(d)


def take(it, n):
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("start", [0, 3])
def test_grain_batches_are_geas_bit_for_bit(folder, start):
    """Batches of 4 from 13 images (3 a epoch): 6 batches cross two epoch
    boundaries."""
    paths = pipeline.list_images(folder)
    args = (paths, 4, 32, 24)
    port = take(GrainFolderLoader(*args, workers=2, seed=5).batches(start), 6)
    ref = take(JaxGrainFolderLoader(*args, workers=2, seed=5).batches(start), 6)
    for a, b in zip(port, ref):
        assert a.dtype == np.uint8 and a.shape == (4, 24, 24, 3)
        np.testing.assert_array_equal(a, b)


def test_grain_restart_is_the_stream_from_there(folder):
    loader = GrainFolderLoader(pipeline.list_images(folder), 4, 32, 24, seed=5)
    full = take(loader.batches(0), 6)
    for a, b in zip(take(loader.batches(3), 3), full[3:]):
        np.testing.assert_array_equal(a, b)


def test_grain_refuses_fewer_images_than_a_batch(folder):
    with pytest.raises(ValueError, match="grain loader input has 13 images but batch_size is 16"):
        GrainFolderLoader(pipeline.list_images(folder), 16, 32, 24)


def test_grain_missing_raises_and_never_falls_back(folder, monkeypatch):
    monkeypatch.setitem(sys.modules, "grain", None)
    with pytest.raises(ImportError):
        pipeline.make_dataset(TrainGLISConfig(dataset="folder", dataroot=folder, batch_size=4,
                                              data_backend="grain"))


@pytest.mark.parametrize("extra", [
    ["--dataset", "folder", "--data_backend", "grain"],
    ["--dataset", "lsun", "--lsun_classes", "tower,church"],
], ids=["grain", "lsun"])
def test_trainer_reads_the_new_loaders(root, tmp_path, capsys, extra):
    dataroot = str(root)
    if "grain" in extra:
        dataroot = str(root / "church")
    state, _ = train_glis.main([
        "--device", "cpu", "--image_size", "16", "--crop_size", "32", "--code_size", "16",
        "--num_features", "4", "--max_features", "16", "--r_iterations", "1",
        "--batch_size", "4", "--dtype", "float32", "--niter", "2", "--vis_interval", "0",
        "--vis_rows", "2", "--dataroot", dataroot, "--save_path", str(tmp_path / "run"),
        *extra])
    assert state.step == 2
    out = capsys.readouterr().out
    assert ("decoded by grain" if "grain" in extra else "decoded by") in out


def test_import_loads_no_jax():
    code = ("import sys, gea_torch, gea_torch.data.grain_loader, gea_torch.data.lsun;"
            "assert 'jax' not in sys.modules and 'grain' not in sys.modules;"
            "assert 'lmdb' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_no_port_file_imports_grain_or_lmdb_at_module_level():
    files = (sorted((ROOT / "gea_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "tests").glob("test_torch_port_*_card.py"))
             + [ROOT / "tests" / "torch_port_card_cases.py",
                ROOT / "tests" / "torch_port_card_runs.py"])
    for path in files:
        body = ast.parse(path.read_text()).body
        for node in body:
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not {n.split(".")[0] for n in names} & {"grain", "lmdb", "jax"}, path
