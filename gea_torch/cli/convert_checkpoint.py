"""Checkpoint converter of the port (port of `gea/cli/convert_checkpoint.py`):
a port run directory <-> one PyTorch file in `gea`'s "gea-torch-v1"
format, the bridge between the two packages' runs.

The file holds the run's `config` (its config.json), its `step`, and the
state_dicts of `generator`, `discriminator` and `reverter` (each where the
run has one) in the layout of `gea/interop/torch_port.py`'s converters,
which is the port's own module layout. An R-iterative run's generator is
its single-stage conv core; an R-separate run holds R alone.

Export a port run (the latest step; --step N, or -1 for best.json;
--use_ema for G's EMA shadow) and import it into `gea`:

    python -m gea_torch.cli.convert_checkpoint --load_path runs/glis3_80 \\
        --step -1 --out glis3_80.pt
    python -m gea.cli.convert_checkpoint --from_torch glis3_80.pt --out_run runs/gea_imported

Import a `gea` export into a port run directory (`config.json` and
`checkpoints/<step>/state.pt` holding just the modules), which the port's
samplers, `info` and evaluators read:

    python -m gea.cli.convert_checkpoint --load_path runs/gea_run --out gea_run.pt
    python -m gea_torch.cli.convert_checkpoint --from_torch gea_run.pt \\
        --out_run runs/imported
    python -m gea_torch.cli.sample --load_path runs/imported ...
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import torch

from gea_torch.config import TrainGLISConfig, TrainRIterativeConfig, TrainRSeparateConfig
from gea_torch.models import Discriminator, GeneratorLIS, Reverter
from gea_torch.train.state import generator_config
from gea_torch.utils.checkpoint import load_checkpoint, write_modules

FORMAT = "gea-torch-v1"
_MODULES = ("generator", "discriminator", "reverter")


def _modules(raw_cfg: dict) -> dict:
    """name -> a CPU module of the run's architecture, for each module a
    run of this kind holds: R-separate R alone; R-iterative the
    single-stage G, D and R; G-LIS G and D."""
    if "g_path" in raw_cfg:
        return {"reverter": Reverter(TrainRSeparateConfig.load_dict(raw_cfg), device="cpu")}
    if "r_chain_length" in raw_cfg:
        cfg = TrainRIterativeConfig.load_dict(raw_cfg)
        return {"generator": GeneratorLIS(generator_config(cfg), device="cpu"),
                "discriminator": Discriminator(cfg, device="cpu"),
                "reverter": Reverter(cfg, device="cpu")}
    cfg = TrainGLISConfig.load_dict(raw_cfg)
    return {"generator": GeneratorLIS(cfg, device="cpu"),
            "discriminator": Discriminator(cfg, device="cpu")}


def export_run(load_path: str, out: str, step: Optional[int], use_ema: bool) -> dict:
    with open(os.path.join(load_path, "config.json")) as f:
        raw_cfg = json.load(f)
    ckpt = load_checkpoint(load_path, step)
    payload = {"format": FORMAT, "config": raw_cfg, "step": int(ckpt.get("step", 0))}
    is_r_separate = "g_path" in raw_cfg
    if not is_r_separate:
        weights = ckpt.get("generator")
        if use_ema:
            if not ckpt.get("g_ema"):
                raise SystemExit("--use_ema: checkpoint has no EMA params (train with "
                                 "--g_ema > 0)")
            weights = {**weights, **ckpt["g_ema"]}
        if weights:
            payload["generator"] = dict(weights)
        if ckpt.get("discriminator"):
            payload["discriminator"] = dict(ckpt["discriminator"])
    if ckpt.get("reverter"):
        payload["reverter"] = dict(ckpt["reverter"])
    if is_r_separate and "generator" not in payload:
        print("[gea_torch] note: R-separate runs hold only the reverter; export the frozen "
              f"generator from its own run dir ({raw_cfg.get('g_path', '?')})")

    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    torch.save(payload, out)
    comps = sorted(k for k in _MODULES if k in payload)
    print(f"[gea_torch] exported step {payload['step']} of {load_path} -> {out} "
          f"({', '.join(comps)})")
    return payload


def import_torch(torch_path: str, out_run: str, step: Optional[int]) -> None:
    """Write the modules of a gea-torch-v1 file into a port run directory
    at `step` (the file's own step for None), after loading each into a
    module of the run's architecture (strict)."""
    payload = torch.load(torch_path, map_location="cpu", weights_only=True)
    if payload.get("format") != FORMAT:
        raise SystemExit(f"{torch_path!r} is not a {FORMAT} export; importing arbitrary torch "
                         "checkpoints requires the documented key schema")
    raw_cfg = payload["config"]
    ckpt_step = step if step is not None else int(payload.get("step", 0))
    modules = {}
    for name, module in _modules(raw_cfg).items():
        if name in payload:
            module.load_state_dict(payload[name], strict=True)
            modules[name] = module.state_dict()

    out_run = os.path.abspath(out_run)
    os.makedirs(out_run, exist_ok=True)
    with open(os.path.join(out_run, "config.json"), "w") as f:
        json.dump(raw_cfg, f, indent=2, sort_keys=True)
    write_modules(out_run, ckpt_step, modules)
    print(f"[gea_torch] imported {torch_path} -> {out_run} (checkpoint step {ckpt_step}; "
          "loadable by the samplers/eval CLIs)")


def main(argv: Optional[list] = None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--load_path", default="", help="port run dir to export")
    p.add_argument("--out", default="", help="output .pt path for export")
    p.add_argument("--step", type=int, default=0,
                   help="checkpoint step (0 = latest, -1 = best per --fid_interval)")
    p.add_argument("--use_ema", action="store_true",
                   help="export the EMA copy of G (runs trained with --g_ema > 0)")
    p.add_argument("--from_torch", default="", help=".pt file to import into a run dir")
    p.add_argument("--out_run", default="", help="port run dir to create on import")
    a = p.parse_args(argv)

    if a.from_torch:
        if not a.out_run:
            raise SystemExit("--from_torch requires --out_run")
        if a.step < 0:
            # -1 means best.json on export; the file has no best.json.
            raise SystemExit("--step -1 (best) is only valid for export")
        return import_torch(a.from_torch, a.out_run, a.step or None)
    if not (a.load_path and a.out):
        raise SystemExit("export requires --load_path and --out")
    return export_run(a.load_path, a.out, a.step or None, a.use_ema)


if __name__ == "__main__":
    main()
