"""The procedural demo dataset of the port (port of
`gea/cli/make_demo_data.py`): a folder of JPEGs drawn from
`np.random.default_rng(--seed)` with numpy and PIL, byte for byte the
images `gea` writes with the same flags on the same pillow and libjpeg.

Two generators, by --style:

* ``diverse`` (default): a background (linear, radial, striped gradient or
  a smooth color field), 1-3 posed subjects (superellipse, star/flower or
  ring, each with its own position, rotation, scale, edge softness and
  fill), 0-2 dark dots on the front subject, brightness/contrast jitter,
  sensor noise, and a mild blur on about a third of the images;
* ``blobs``: a gradient background, one soft central ellipse and two eye
  dots.

The dump used for the documented runs (`data/demo20k/MANIFEST.json`):

    python -m gea_torch.cli.make_demo_data --out data/demo20k --count 20000 \\
        --size 200 --seed 0 --quality 92 --style diverse

Images are written at --size (default 200) so the transform chain
CenterCrop(160) -> Resize(80) applies unchanged. MANIFEST.json records the
command, the library versions that encoded the JPEGs, the sha256 of the
whole dump and of 17 spot-check files.
"""

from __future__ import annotations

import argparse
import colorsys
import hashlib
import json
import os
import sys

import numpy as np


def render_image(rng: np.random.Generator, size: int) -> np.ndarray:
    """One ``blobs`` sample: gradient background + soft central ellipse +
    two eye dots, uint8 HWC."""
    s = size
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s

    # Two-color linear gradient background at a random angle.
    c0 = rng.uniform(0.1, 0.9, 3).astype(np.float32)
    c1 = rng.uniform(0.1, 0.9, 3).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi)
    t = (xx * np.cos(ang) + yy * np.sin(ang) + 1) / 2
    img = c0 * (1 - t[..., None]) + c1 * t[..., None]

    # Soft-edged ellipse blob near the center (the "face").
    cx = 0.5 + rng.uniform(-0.08, 0.08)
    cy = 0.5 + rng.uniform(-0.08, 0.08)
    rx = rng.uniform(0.16, 0.30)
    ry = rx * rng.uniform(0.8, 1.35)
    theta = rng.uniform(-0.5, 0.5)
    dx, dy = xx - cx, yy - cy
    u = dx * np.cos(theta) + dy * np.sin(theta)
    v = -dx * np.sin(theta) + dy * np.cos(theta)
    d = np.sqrt((u / rx) ** 2 + (v / ry) ** 2)
    mask = np.clip((1.15 - d) / 0.3, 0, 1)[..., None]
    blob = rng.uniform(0.2, 1.0, 3).astype(np.float32)
    img = img * (1 - mask) + blob * mask

    # Two small darker "eye" dots make orientation learnable.
    for sx in (-1, 1):
        ex, ey = cx + sx * rx * 0.4, cy - ry * 0.25
        de = np.sqrt((xx - ex) ** 2 + (yy - ey) ** 2)
        em = np.clip((0.035 - de) / 0.015, 0, 1)[..., None]
        img = img * (1 - em * 0.8)

    img += rng.normal(0, 0.015, img.shape).astype(np.float32)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _hsv(rng: np.random.Generator, s=(0.2, 1.0), v=(0.25, 1.0)) -> np.ndarray:
    """HSV-sampled RGB color: a uniform hue spreads the palette, where
    uniform RGB clusters near gray."""
    return np.asarray(
        colorsys.hsv_to_rgb(rng.uniform(), rng.uniform(*s), rng.uniform(*v)), np.float32)


def _background(rng, xx, yy):
    c0, c1 = _hsv(rng), _hsv(rng)
    kind = int(rng.integers(4))
    if kind == 0:  # linear gradient, any angle
        ang = rng.uniform(0, 2 * np.pi)
        t = (xx * np.cos(ang) + yy * np.sin(ang) + 1.0) / 2.0
    elif kind == 1:  # radial gradient, off-center
        cx, cy = rng.uniform(0.15, 0.85, 2)
        t = np.clip(np.hypot(xx - cx, yy - cy) / rng.uniform(0.5, 1.2), 0, 1)
    elif kind == 2:  # soft stripes
        ang = rng.uniform(0, np.pi)
        f = rng.uniform(1.5, 7.0)
        ph = rng.uniform(0, 2 * np.pi)
        t = 0.5 + 0.5 * np.sin(2 * np.pi * f * (xx * np.cos(ang) + yy * np.sin(ang)) + ph)
    else:  # smooth random color field (sum of 3 plane waves)
        t = np.zeros_like(xx)
        for _ in range(3):
            fx, fy = rng.uniform(-3, 3, 2)
            t += np.sin(2 * np.pi * (fx * xx + fy * yy) + rng.uniform(0, 7))
        t = (t - t.min()) / max(float(np.ptp(t)), 1e-6)
    return c0 * (1 - t[..., None]) + c1 * t[..., None]


def _subject_mask(rng, xx, yy):
    """Soft [0, 1] mask of one posed subject: a superellipse (p-norm
    1.6..8), a star/flower (3-9 lobes) or a ring. Returns (mask, (u, v)
    subject-frame coordinates for the fill, (cx, cy, scale))."""
    cx, cy = 0.5 + rng.uniform(-0.35, 0.35, 2)
    rx = rng.uniform(0.06, 0.32)
    ry = rx * rng.uniform(0.55, 1.8)
    theta = rng.uniform(0, 2 * np.pi)
    dx, dy = xx - cx, yy - cy
    u = dx * np.cos(theta) + dy * np.sin(theta)
    v = -dx * np.sin(theta) + dy * np.cos(theta)

    family = int(rng.integers(3))
    if family == 0:  # superellipse
        p = rng.uniform(1.6, 8.0)
        d = (np.abs(u / rx) ** p + np.abs(v / ry) ** p) ** (1.0 / p)
    elif family == 1:  # star / flower: radius modulated by lobes
        k = int(rng.integers(3, 10))
        amp = rng.uniform(0.08, 0.38)
        phi = np.arctan2(v / ry, u / rx)
        rho = np.hypot(u / rx, v / ry)
        d = rho / np.maximum(1.0 + amp * np.cos(k * phi), 1e-3)
    else:  # ring
        rho = np.hypot(u / rx, v / ry)
        w = rng.uniform(0.18, 0.55)
        d = np.abs(rho - 1.0) / w
    edge = rng.uniform(0.02, 0.30)
    mask = np.clip((1.0 + edge - d) / edge, 0.0, 1.0)
    return mask[..., None], (u, v), (cx, cy, max(rx, ry))


def _subject_fill(rng, xx, u, v):
    """A subject's fill: a solid color, a 2-color gradient in the subject's
    frame, or a sinusoidal stripe texture between two colors."""
    c0 = _hsv(rng)
    kind = int(rng.integers(3))
    if kind == 0:
        return c0[None, None, :] * np.ones_like(xx)[..., None]
    c1 = _hsv(rng)
    if kind == 1:  # gradient along a random subject-frame axis
        ang = rng.uniform(0, 2 * np.pi)
        t = np.clip((u * np.cos(ang) + v * np.sin(ang)) / 0.6 + 0.5, 0, 1)
    else:  # stripes
        ang = rng.uniform(0, np.pi)
        f = rng.uniform(6.0, 28.0)
        t = 0.5 + 0.5 * np.sin(2 * np.pi * f * (u * np.cos(ang) + v * np.sin(ang)))
    return c0 * (1 - t[..., None]) + c1 * t[..., None]


def render_diverse(rng: np.random.Generator, size: int) -> np.ndarray:
    """One ``diverse`` sample: background + 1-3 posed, filled subjects +
    dots + global jitter, uint8 HWC."""
    s = size
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s

    img = _background(rng, xx, yy)

    n_subjects = int(rng.integers(1, 4))
    front = None
    for _ in range(n_subjects):
        mask, (u, v), geo = _subject_mask(rng, xx, yy)
        fill = _subject_fill(rng, xx, u, v)
        img = img * (1 - mask) + fill * mask
        front = (mask, geo)

    # 0-2 dark dots on the front subject: a cheap orientation cue.
    if front is not None and rng.uniform() < 0.6:
        mask, (cx, cy, r) = front
        for _ in range(int(rng.integers(1, 3))):
            ex = cx + rng.uniform(-0.5, 0.5) * r
            ey = cy + rng.uniform(-0.5, 0.5) * r
            rr = rng.uniform(0.015, 0.035)
            de = np.hypot(xx - ex, yy - ey)
            em = np.clip((rr - de) / (rr * 0.5), 0, 1)[..., None]
            img = img * (1 - em * mask * rng.uniform(0.5, 0.9))

    # Global exposure/contrast jitter + sensor noise.
    img = (img - 0.5) * rng.uniform(0.75, 1.15) + 0.5 + rng.uniform(-0.08, 0.08)
    img += rng.normal(0, rng.uniform(0.004, 0.025), img.shape).astype(np.float32)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


RENDERERS = {"diverse": render_diverse, "blobs": render_image}


def library_versions() -> dict:
    """The versions that decide the JPEG bytes: python, numpy, pillow and
    the libjpeg pillow encodes with."""
    import PIL
    from PIL import features

    return {"python": sys.version.split()[0], "numpy": np.__version__,
            "pillow": PIL.__version__, "libjpeg": features.version("jpg")}


def write_manifest(out_dir: str, args: argparse.Namespace) -> dict:
    """Pin the dump's provenance in <out_dir>/MANIFEST.json: the command
    that regenerates it, the library versions that encoded the JPEGs, the
    sha256 of every file folded into one dump digest, and per-file hashes
    of a fixed spot-check sample (every len // 16-th file and the last)."""
    files = sorted(f for f in os.listdir(out_dir) if f.lower().endswith((".jpg", ".jpeg", ".png")))
    dump = hashlib.sha256()
    spot = {}
    stride = max(1, len(files) // 16)
    for i, name in enumerate(files):
        with open(os.path.join(out_dir, name), "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        dump.update(name.encode())
        dump.update(bytes.fromhex(digest))
        if i % stride == 0 or i == len(files) - 1:
            spot[name] = digest
    manifest = {
        "command": "python -m gea_torch.cli.make_demo_data " + " ".join(
            f"--{k} {getattr(args, k)}"
            for k in ("out", "count", "size", "seed", "quality", "style")),
        "count": len(files),
        "style": args.style,
        "size": args.size,
        "seed": args.seed,
        "quality": args.quality,
        "versions": library_versions(),
        "sha256_dump": dump.hexdigest(),
        "sha256_spot_check": spot,
    }
    path = os.path.join(out_dir, "MANIFEST.json")
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    print(f"[gea_torch] manifest: {path} (dump sha256 {manifest['sha256_dump'][:16]}...)")
    return manifest


def main(argv=None) -> None:
    from PIL import Image, ImageFilter

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True, help="output folder")
    p.add_argument("--count", type=int, default=20000)
    p.add_argument("--size", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quality", type=int, default=92)
    p.add_argument("--style", choices=sorted(RENDERERS), default="diverse",
                   help="'diverse' (compositional scenes) or 'blobs' (the single-ellipse "
                   "generator)")
    p.add_argument("--manifest_only", action="store_true",
                   help="skip generation; hash the EXISTING files in --out into MANIFEST.json, "
                   "recording this command line's flags as the claimed provenance (pass the "
                   "flags the dump was made with)")
    a = p.parse_args(argv)

    if a.manifest_only:
        write_manifest(a.out, a)
        return

    render = RENDERERS[a.style]
    os.makedirs(a.out, exist_ok=True)
    rng = np.random.default_rng(a.seed)
    for i in range(a.count):
        im = Image.fromarray(render(rng, a.size))
        # The blur draw comes after the image's own draws: the order of rng
        # calls decides every later image.
        if a.style == "diverse" and rng.uniform() < 0.35:
            im = im.filter(ImageFilter.GaussianBlur(rng.uniform(0.6, 2.2)))
        im.save(os.path.join(a.out, f"img{i:05d}.jpg"), quality=a.quality)
        if (i + 1) % 2000 == 0:
            print(f"[gea_torch] {i + 1}/{a.count} written", flush=True)
    print(f"[gea_torch] wrote {a.count} {a.size}x{a.size} '{a.style}' JPEGs to {a.out}")
    write_manifest(a.out, a)


if __name__ == "__main__":
    main()
