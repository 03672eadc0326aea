"""LSUN as image folders (port of `gea/data/lsun.py`): `--dataset lsun
--lsun_classes a,b` trains on the folder backends of
`gea_torch.data.pipeline`.

LSUN ships one LMDB per class of raw JPEG/WebP blobs. Each requested class
is either a plain image folder `<dataroot>/<class>/`, used as it is, or an
LMDB `<dataroot>/<class>_train_lmdb/data.mdb` (or `<class>_train/`,
`<class>/`), exported once into `<dataroot>/<class>_train_images/` with a
`.complete` marker (`export_class`); several classes are joined under a
symlink farm `<dataroot>/_lsun_<sorted classes joined by _>`. The files,
their names and the marker are `gea`'s byte for byte.

`lmdb` is imported only to export. Without it, and without a finished
export, the export raises `gea`'s RuntimeError, which says what to do
instead.
"""

from __future__ import annotations

import os
from typing import List

# The name of a multi-class farm starts so; `pipeline.list_images` follows
# symlinked folders only there.
FARM_PREFIX = "_lsun_"


def _lsun_lmdb_dir(dataroot: str, cls: str) -> str:
    for name in (f"{cls}_train_lmdb", f"{cls}_train", cls):
        p = os.path.join(dataroot, name)
        if os.path.isdir(p) and os.path.exists(os.path.join(p, "data.mdb")):
            return p
    return ""


def _export_dir(dataroot: str, cls: str) -> str:
    return os.path.join(dataroot, f"{cls}_train_images")


def export_class(dataroot: str, cls: str, limit: int = 0) -> str:
    """Export one class's LMDB to a folder of image files and return the
    folder: `<n:08d>_<key[:64]>.webp` for a RIFF blob, `.jpg` otherwise.
    Idempotent: the `.complete` marker (holding the count) skips it. An
    export of 0 images raises and writes no marker."""
    out = _export_dir(dataroot, cls)
    marker = os.path.join(out, ".complete")
    if os.path.exists(marker):
        return out
    lmdb_path = _lsun_lmdb_dir(dataroot, cls)
    if not lmdb_path:
        raise FileNotFoundError(
            f"no LSUN lmdb for class {cls!r} under {dataroot!r} "
            f"(expected {cls}_train_lmdb/data.mdb)")
    try:
        import lmdb
    except ImportError as e:
        raise RuntimeError(
            "lsun export needs the 'lmdb' package, which this image does "
            "not provide. Export the LMDB to an image folder elsewhere "
            f"(any file layout under {out!r} + touch {marker!r}), or point "
            "--dataset folder --dataroot at an existing image dump.") from e
    os.makedirs(out, exist_ok=True)
    env = lmdb.open(lmdb_path, max_readers=8, readonly=True, lock=False, readahead=False)
    n = 0
    with env.begin(write=False) as txn:
        for key, val in txn.cursor():
            ext = ".webp" if val[:4] == b"RIFF" else ".jpg"
            name = key.decode("ascii", "replace")[:64]
            with open(os.path.join(out, f"{n:08d}_{name}{ext}"), "wb") as f:
                f.write(val)
            n += 1
            if limit and n >= limit:
                break
    env.close()
    if n == 0:
        # A marker here would hand the folder backends an empty directory
        # for good.
        raise ValueError(f"LSUN export from {lmdb_path!r} produced 0 images "
                         "(corrupt or empty LMDB?)")
    with open(marker, "w") as f:
        f.write(f"{n}\n")
    return out


def resolve_lsun_root(cfg) -> str:
    """The image folder of cfg.lsun_classes under cfg.dataroot, exporting
    LMDBs as needed; several classes resolve to a symlink farm of their
    folders, which the folder backends walk recursively."""
    classes: List[str] = [c.strip() for c in cfg.lsun_classes.split(",") if c.strip()]
    if not classes:
        raise ValueError("--lsun_classes resolved to an empty class list")
    roots = []
    for cls in classes:
        plain = os.path.join(cfg.dataroot, cls)
        if os.path.isdir(plain) and not os.path.exists(os.path.join(plain, "data.mdb")):
            roots.append(plain)
        else:
            roots.append(export_class(cfg.dataroot, cls))
    if len(roots) == 1:
        return roots[0]
    farm = os.path.join(cfg.dataroot, FARM_PREFIX + "_".join(sorted(classes)))
    os.makedirs(farm, exist_ok=True)
    for r in roots:
        link = os.path.join(farm, os.path.basename(r))
        if not os.path.lexists(link):
            os.symlink(r, link)
    return farm
