"""Rules of the PyTorch port: it imports nothing of JAX or of `gea`, it
imports on a host without CUDA, and its entry points never fall back to the
CPU on their own."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "optax", "orbax", "gea")


def _port_files():
    return sorted((ROOT / "gea_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax_or_gea(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_without_cuda_builds_nothing():
    """`import gea_torch` (and every module, the trainer's too) works on a
    CPU-only host, starts no build and imports no triton."""
    code = (
        "import sys, gea_torch, gea_torch.serve, gea_torch.interop, gea_torch.ops;"
        "import gea_torch.train, gea_torch.train.losses, gea_torch.train.state;"
        "import gea_torch.train.steps, gea_torch.train.runner, gea_torch.cli.train_glis;"
        "import gea_torch.data.pipeline, gea_torch.data.ondevice, gea_torch.data.hostpre;"
        "import gea_torch.data.prefetch, gea_torch.data.devicecache;"
        "import gea_torch.utils.checkpoint, gea_torch.utils.grids, gea_torch.utils.plotting;"
        "import gea_torch.utils.meters, gea_torch.utils.hostmem;"
        "import gea_torch.models.reverter, gea_torch.train.steps_r, gea_torch.cli.sample;"
        "import gea_torch.cli.train_r_separate, gea_torch.cli.train_r_iterative;"
        "import gea_torch.eval, gea_torch.eval.fid, gea_torch.cli.compute_fid;"
        "import gea_torch.cli.eval_stages, gea_torch.cli.eval_chain;"
        "import gea_torch.cli.sample_r_separate, gea_torch.cli.sample_r_iterative;"
        "import gea_torch.cli.sample_interpolations, gea_torch.cli.info;"
        "import gea_torch.cli.convert_checkpoint, gea_torch.cli.make_demo_data;"
        "import gea_torch.serve_http, gea_torch.cli.export_model, gea_torch.parallel;"
        "assert 'PIL' not in sys.modules and 'matplotlib' not in sys.modules;"
        "assert 'scipy' not in sys.modules;"
        "from gea_torch.ops import build;"
        "assert build._LIBS == {} and not build.BUILD_DIR.joinpath('x').exists();"
        "assert 'triton' not in sys.modules and 'jax' not in sys.modules;"
        "assert not any(m == 'gea' or m.startswith('gea.') for m in sys.modules)"
    )
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=120)


def test_serving_model_on_default_device_needs_cuda(monkeypatch):
    from gea_torch import ModelConfig
    from gea_torch.interop import generator_from_jax_params, init_generator_params

    cfg = ModelConfig(image_size=32, code_size=16, r_iterations=1,
                      num_features=8, max_features=32, dtype="float32")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generator_from_jax_params(init_generator_params(cfg), cfg)
    # Asked for explicitly, the CPU works.
    from gea_torch.serve import ServingModel

    g = generator_from_jax_params(init_generator_params(cfg), cfg, device="cpu")
    out = ServingModel.from_modules(g)(np.zeros((1, 16), np.float32))
    assert out["images"].shape == (1, 32, 32, 3)


def test_train_state_on_default_device_needs_cuda(monkeypatch):
    from gea_torch.config import TrainGLISConfig
    from gea_torch.train import build_glis_train_step, create_glis_state

    cfg = TrainGLISConfig(image_size=16, code_size=16, r_iterations=1,
                          num_features=4, max_features=16, dtype="float32", batch_size=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_glis_state(cfg)
    # Asked for explicitly, the CPU works.
    state = create_glis_state(cfg, device="cpu")
    metrics = build_glis_train_step(cfg)(state, np.zeros((2, 16, 16, 3), np.float32))
    assert state.step == 1 and all(v.device.type == "cpu" for v in metrics.values())


def test_r_states_on_default_device_need_cuda(monkeypatch):
    from gea_torch.config import TrainRIterativeConfig, TrainRSeparateConfig
    from gea_torch.interop import generator_from_jax_params, init_generator_params
    from gea_torch.train import (
        build_r_iterative_step,
        build_r_separate_step,
        create_r_iterative_state,
        create_r_state,
    )

    tiny = dict(image_size=16, code_size=16, r_iterations=1, num_features=4,
                max_features=16, dtype="float32", batch_size=2, r_hidden=8)
    sep, it = TrainRSeparateConfig(**tiny), TrainRIterativeConfig(**tiny)
    g = generator_from_jax_params(init_generator_params(sep), sep, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_r_state(sep, g)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_r_iterative_state(it)
    # Asked for explicitly, the CPU works.
    state = create_r_state(sep, g, device="cpu")
    metrics = build_r_separate_step(sep)(state)
    assert state.step == 1 and all(v.device.type == "cpu" for v in metrics.values())
    state = create_r_iterative_state(it, device="cpu")
    metrics = build_r_iterative_step(it)(state, np.zeros((2, 16, 16, 3), np.float32))
    assert state.step == 1 and all(v.device.type == "cpu" for v in metrics.values())


@pytest.mark.parametrize("cli", ["train_r_separate", "train_r_iterative"])
def test_r_clis_on_default_device_need_cuda(monkeypatch, tmp_path, cli):
    """Without --device cpu the R trainers raise on a host without CUDA."""
    import importlib

    mod = importlib.import_module(f"gea_torch.cli.{cli}")
    args = ["--save_path", str(tmp_path / "r"), "--dataset", "synthetic"]
    if cli == "train_r_separate":
        args += ["--g_path", str(tmp_path)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(args)


@pytest.mark.parametrize("cli", ["compute_fid", "eval_stages", "eval_chain"])
def test_eval_clis_on_default_device_need_cuda(monkeypatch, tmp_path, cli):
    """Without --device cpu the evaluators raise on a host without CUDA,
    before they read the run directory."""
    import importlib

    mod = importlib.import_module(f"gea_torch.cli.{cli}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(["--load_path", str(tmp_path / "missing")])


@pytest.mark.parametrize("cli", ["sample", "sample_interpolations", "sample_r_separate",
                                 "sample_r_iterative"])
def test_samplers_on_default_device_need_cuda(monkeypatch, tmp_path, cli):
    """Without --device cpu the samplers raise on a host without CUDA,
    before they read the run directory."""
    import importlib

    mod = importlib.import_module(f"gea_torch.cli.{cli}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(["--load_path", str(tmp_path / "missing")])


def test_serving_on_default_device_needs_cuda(monkeypatch, tmp_path):
    """Without device="cpu" (--device cpu) `load`, `export_model`,
    `python -m gea_torch.serve` and the HTTP server raise on a host without
    CUDA, before they read the artifact or the run."""
    from gea_torch import serve, serve_http
    from gea_torch.cli import export_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "missing")
    for call in (lambda: serve.load(missing),
                 lambda: export_model.main(["--load_path", missing, "--out", missing]),
                 lambda: serve._main([missing]),
                 lambda: serve_http.make_server(missing)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_new_port_files_are_checked():
    """The import rule above covers the evaluation modules, the samplers
    and the remaining CLIs."""
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {"gea_torch/eval/fid.py", "gea_torch/cli/compute_fid.py", "gea_torch/cli/eval_stages.py",
            "gea_torch/cli/eval_chain.py", "gea_torch/cli/sample_r_separate.py",
            "gea_torch/cli/sample.py", "gea_torch/cli/sample_interpolations.py",
            "gea_torch/cli/sample_r_iterative.py", "gea_torch/cli/info.py",
            "gea_torch/cli/convert_checkpoint.py", "gea_torch/cli/make_demo_data.py",
            "gea_torch/serve_http.py", "gea_torch/cli/export_model.py",
            "gea_torch/parallel/mesh.py", "gea_torch/parallel/dp.py",
            "gea_torch/parallel/tp.py", "gea_torch/data/lsun.py",
            "gea_torch/data/grain_loader.py"} <= names


def test_chip_smoke_refuses_without_cuda():
    """Without CUDA the smoke script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the script runs for real there")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
