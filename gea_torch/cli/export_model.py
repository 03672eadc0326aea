"""Export a trained run of the port as a self-contained serving artifact
(port of `gea/cli/export_model.py`).

`torch.export` traces the inference function (`gea_torch.serve.
ServeFunction`: the final-stage render, optionally every stage and the
discriminator's realism score) into a program with the weights inside, with
a symbolic batch dimension unless `--batch` pins one, and
`torch.export.save` writes it as `model.pt2` beside `manifest.json`. The
three kernels are `torch.library` custom ops, so the program calls them by
name (`gea_torch::fused_tprelu`, `::lis_residual_mlp`, `::fused_seed`):
on the card it launches the same kernels as the live render, on the CPU
their plain versions. Loading it back (`gea_torch.serve.load`) needs
`gea_torch` and no model code, run directory or config.

    python -m gea_torch.cli.export_model --load_path runs/glis3_80 \\
        --out exports/glis3_80 --with_scores 1

On the CPU, against the tiny run of `gea_torch/cli/train_glis.py`'s
docstring:

    python -m gea_torch.cli.export_model --device cpu --platforms cpu \\
        --load_path "$RUN" --out /tmp/art --all_stages 1

With `--r_path <R-separate run>` the input-space correction is baked in
(blend z toward R(G(z)) for --correction_steps, then render); `--ri_path
<R-iterative run>` exports the jointly trained chain
z_t = z_{t-1} + R(G(z_{t-1})) instead.

The program is traced on `--device` and written with its weights on the
host, so it loads on either device: `serve.load(path, device)` moves it
there (`torch.export.passes.move_to_device_pass`). `--platforms` lists the
devices it is declared for; `load` refuses the others.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import numpy as np
import torch

from gea_torch import serve
from gea_torch.cli.sample import load_discriminator, load_generator, read_run
from gea_torch.cli.sample_r_separate import load_reverter
from gea_torch.config import TrainRIterativeConfig, resolve_device
from gea_torch.models import Discriminator, GeneratorLIS, Reverter
from gea_torch.train.state import generator_config
from gea_torch.utils.checkpoint import best_step, latest_step

EXAMPLE_BATCH = 3  # the batch the symbolic program is traced at


def _resolve_step(load_path: str, step: int) -> Optional[int]:
    """0 = latest, -1 = best.json (the --step convention of every tool)."""
    if step == 0:
        return latest_step(load_path)
    if step == -1:
        resolved = best_step(load_path)
        if resolved is None:
            raise SystemExit(f"--step -1: no best.json under {load_path!r} (train with "
                             "--fid_interval to track a best snapshot)")
        return resolved
    return step


def parse_platforms(text: str) -> list:
    platforms = [s.strip() for s in text.split(",") if s.strip()]
    bad = [p for p in platforms if p not in serve.PLATFORMS]
    if bad or not platforms:
        raise SystemExit(f"--platforms takes {' and/or '.join(serve.PLATFORMS)}, got {text!r}"
                         " (the port serves on the card or the host, not on a TPU)")
    return platforms


def export_program(live: serve.ServingModel, batch: int) -> torch.export.ExportedProgram:
    """`torch.export` of `live`'s `ServeFunction` on its device, under
    no_grad: the batch is symbolic ("b", shared by z and the spatial noise)
    unless `batch` > 0 pins it."""
    n = batch or EXAMPLE_BATCH
    args = [torch.zeros((n, live.code_size), device=live.device)]
    if live.spatial_noise_shape is not None:
        args.append(torch.zeros((n, *live.spatial_noise_shape), device=live.device))
    dynamic = None
    if not batch:
        b = torch.export.Dim("b", min=1)
        dynamic = tuple({0: b} for _ in args)
    with torch.no_grad():
        return torch.export.export(live.exported, tuple(args), dynamic_shapes=dynamic)


def selfcheck(out_dir: str, live: serve.ServingModel, batch: int, bf16: bool,
              device: torch.device) -> None:
    """Load the artifact back and hold it against the live render: at
    batches 3 and 5 (a pinned artifact at its batch), max uint8 diff 1 (3 in
    bf16) with at most 1% of pixels beyond 1 level, scores in [0, 1]."""
    model = serve.load(out_dir, device=device)
    rng = np.random.default_rng(0)
    sn_shape = live.spatial_noise_shape
    for n in (3, 5) if batch == 0 else (batch,):
        z = rng.standard_normal((n, live.code_size)).astype(np.float32)
        sn = rng.standard_normal((n, *sn_shape)).astype(np.float32) if sn_shape else None
        got, want = model(z, sn), live(z, sn)
        # The artifact and the live render are separately run programs; in
        # bf16 one ulp near |x| = 1 is 0.0078, one uint8 level of the
        # [-1, 1] -> [0, 255] mapping, so another summation order may move
        # isolated pixels by a couple of levels.
        max_tol = 3 if bf16 else 1
        diff = np.abs(got["images"].astype(int) - want["images"].astype(int))
        frac_over = float((diff > 1).mean())
        if diff.max() > max_tol or frac_over > 0.01:
            raise SystemExit(f"selfcheck FAILED at batch {n}: max uint8 diff {diff.max()} "
                             f"(tol {max_tol}), {frac_over:.2%} of pixels beyond the rounding "
                             "band vs live render")
        if "scores" in got and not np.all((got["scores"] >= 0) & (got["scores"] <= 1)):
            raise SystemExit("selfcheck FAILED: scores outside [0, 1]")
        print(f"[gea_torch] selfcheck ok at batch {n} (max uint8 diff {diff.max()})")


def parse(argv: Optional[list] = None) -> argparse.Namespace:
    """The command line, with `device` resolved and `platforms` a list."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument(
        "--load_path", default="",
        help="trained G-LIS run dir (optional when --r_path is given: defaults to the R "
        "run's recorded frozen-G run + snapshot)",
    )
    p.add_argument("--out", required=True, help="output artifact directory")
    p.add_argument(
        "--r_path", default="",
        help="R-separate run dir: bake input-space correction into the artifact — each "
        "serving call blends z toward R(G(z)) for --correction_steps before the final render",
    )
    p.add_argument("--r_step", type=int, default=0,
                   help="R checkpoint step (0 = latest, -1 = best per --fid_interval)")
    p.add_argument("--correction_steps", type=int, default=1,
                   help="with --r_path: number of correction iterations baked in")
    p.add_argument("--correction_strength", type=float, default=0.3,
                   help="with --r_path: blend weight toward the corrected code")
    p.add_argument("--shell_renorm", type=int, default=1,
                   help="with --r_path: re-project blended codes onto ||z||=sqrt(d)")
    p.add_argument(
        "--ri_path", default="",
        help="R-iterative run dir (jointly trained G/D/R): export the iterative correction "
        "chain z_t = z_{t-1} + R(G(z_{t-1})) — `images` is the chain-end render, `stages` "
        "the per-link view. Mutually exclusive with --load_path/--r_path",
    )
    p.add_argument("--chain_links", type=int, default=0,
                   help="with --ri_path: correction links to unroll (0 = the run's trained "
                   "--r_chain_length)")
    p.add_argument("--step", type=int, default=0,
                   help="checkpoint step (0 = latest, -1 = best per --fid_interval)")
    p.add_argument("--use_ema", action="store_true",
                   help="export the EMA shadow params (--g_ema runs)")
    p.add_argument(
        "--with_scores", type=int, default=1,
        help="bundle the run's discriminator: output sigmoid realism scores of the final "
        "stage for error-avoidance serving (0 = generator only)",
    )
    p.add_argument("--all_stages", type=int, default=0,
                   help="also output every LIS stage (S, B, H, W, 3) uint8")
    p.add_argument("--platforms", default="cuda,cpu",
                   help="comma list of the devices the artifact is declared for: cuda, cpu")
    p.add_argument("--batch", type=int, default=0,
                   help="pin the batch dimension to this size (0 = symbolic batch: one "
                   "artifact serves any batch size)")
    p.add_argument("--selfcheck", type=int, default=1,
                   help="after writing, load the artifact and verify it reproduces the live "
                   "model's render (at two batch sizes when the batch dim is symbolic)")
    p.add_argument("--device", default="cuda",
                   help="device to trace and selfcheck on: cuda, or cpu to run on the host")
    a = p.parse_args(argv)
    a.device = resolve_device(a.device)
    a.platforms = parse_platforms(a.platforms)
    if a.device.type not in a.platforms:
        raise SystemExit(f"--device {a.device.type} is not among --platforms "
                         f"{','.join(a.platforms)}")
    if a.ri_path and (a.load_path or a.r_path):
        raise SystemExit("--ri_path is mutually exclusive with --load_path/--r_path")
    if a.batch < 0:
        raise SystemExit(f"--batch must be >= 0, got {a.batch}")
    return a


def live_model(a: argparse.Namespace) -> Tuple[serve.ServingModel, dict]:
    """The run's modules served live (`ServingModel.from_modules`) as the
    artifact will serve them, and the manifest's keys that describe them."""
    device = a.device
    reverter = correction = chain_links = chain_meta = correction_meta = discriminator = None
    if a.ri_path:
        if a.use_ema:
            raise SystemExit("--use_ema: R-iterative runs keep no EMA shadow")
        # Jointly trained G/D/R: all in the one R-iterative checkpoint; its
        # generator has no LIS modules.
        load_path = a.ri_path
        step = _resolve_step(load_path, a.step)
        train_cfg, ckpt = read_run(load_path, step, TrainRIterativeConfig)
        generator = GeneratorLIS(generator_config(train_cfg), device=device)
        generator.load_state_dict(ckpt["generator"], strict=True)
        reverter = Reverter(train_cfg, device=device)
        reverter.load_state_dict(ckpt["reverter"], strict=True)
        chain_links = a.chain_links or train_cfg.r_chain_length
        chain_meta = {"links": chain_links, "trained_links": train_cfg.r_chain_length}
        if a.with_scores:
            discriminator = Discriminator(train_cfg, device=device)
            discriminator.load_state_dict(ckpt["discriminator"], strict=True)
    else:
        load_path, g_step_flag = a.load_path, a.step
        if a.r_path:
            r_step = _resolve_step(a.r_path, a.r_step)
            reverter, r_cfg = load_reverter(a.r_path, step=r_step, device=device)
            correction = {"steps": a.correction_steps, "strength": a.correction_strength,
                          "shell_renorm": bool(a.shell_renorm)}
            correction_meta = {"r_run": os.path.abspath(a.r_path), "r_step": r_step,
                               **correction}
            if not load_path:
                # Correct the frozen-G snapshot R was trained against.
                load_path, g_step_flag = r_cfg.g_path, r_cfg.g_step
        if not load_path:
            raise SystemExit("--load_path is required (or --r_path/--ri_path with a "
                             "recorded run)")
        step = _resolve_step(load_path, g_step_flag)
        _, restored = read_run(load_path, step)
        generator, train_cfg = load_generator(load_path, device=device, restored=restored,
                                              use_ema=a.use_ema)
        if a.with_scores:
            discriminator = load_discriminator(load_path, device=device, restored=restored)

    gan_loss = getattr(train_cfg, "gan_loss", "bce")
    if discriminator is not None and gan_loss != "bce":
        print(f"[gea_torch] note: this run used --gan_loss {gan_loss}; exported `scores` are "
              "sigmoid(margin) — a valid ranking but not a calibrated probability")
    live = serve.ServingModel.from_modules(
        generator, discriminator, reverter=reverter, correction=correction,
        chain_links=chain_links, all_stages=bool(a.all_stages), gan_loss=gan_loss)
    return live, {
        "platforms": a.platforms,
        "batch": a.batch,
        **live.exported.describe(),
        "use_ema": bool(a.use_ema),
        "source_run": os.path.abspath(load_path),
        "step": step,
        "gan_loss": gan_loss,
        "correction": correction_meta,
        "chain": chain_meta,
        "dtype": train_cfg.dtype,
    }


def main(argv: Optional[list] = None) -> dict:
    a = parse(argv)
    live, described = live_model(a)
    exported = export_program(live, a.batch)
    # Written with its weights on the host, so that a CPU-only host can load
    # it; `serve.load` moves it to the device it serves on.
    from torch.export.passes import move_to_device_pass

    exported = move_to_device_pass(exported, "cpu")
    manifest = {"format": "torch.export/pt2", "torch_version": torch.__version__, **described}
    nbytes = serve.write_artifact(a.out, exported, manifest)
    print(f"[gea_torch] exported step {manifest['step']} -> {a.out} ({nbytes / 1e6:.2f} MB, "
          f"platforms={','.join(a.platforms)}, "
          f"batch={'symbolic' if a.batch == 0 else a.batch})")
    if a.selfcheck:
        selfcheck(a.out, live, a.batch, manifest["dtype"] == "bfloat16", a.device)
    return manifest


if __name__ == "__main__":
    main()
