"""Nothing the benchmark loads is JAX's or `gea`'s, by whole top-level name
(`gea_torch` is allowed; `gea` is not), and the reference and the
yardstick import nothing of the program."""

import ast
import os
import subprocess
import sys

import benchcopy

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "gea"}
PB = os.path.join(benchcopy.ROOT, "portbench")


def imported_tops(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                out.add(str(node.args[0].value).split(".")[0])
    return out


def py_files(sub: str = ""):
    for d, _, files in os.walk(os.path.join(PB, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_gea():
    for path in py_files():
        if os.sep + "tests" + os.sep in path:
            continue
        bad = imported_tops(path) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_reference_and_yardstick_import_nothing_of_the_program():
    for sub in ("reference", "cost"):
        for path in py_files(sub):
            tops = imported_tops(path)
            assert "gea_torch" not in tops and not tops & FORBIDDEN, (path, tops)


def test_loaded_modules_are_not_jax_or_gea():
    """Load the harness, every configuration and mix, every loop and metric
    reader and the reference in a fresh process, then compare every loaded
    module's top-level name, whole."""
    code = r"""
import glob, importlib, json, os, sys
root = sys.argv[1]
sys.path.insert(0, root)
from portbench import harness, reference, cost, compare, faults, spy, tracing, weights
for f in glob.glob(os.path.join(root, "portbench", "configs", "*.json")) + \
        glob.glob(os.path.join(root, "portbench", "mixes", "*.json")):
    json.load(open(f))
for f in glob.glob(os.path.join(root, "portbench", "loops", "*.py")):
    name = os.path.basename(f)[:-3]
    if name != "__init__":
        importlib.import_module("portbench.loops." + name)
for f in glob.glob(os.path.join(root, "portbench", "metrics", "*.py")):
    harness.metric_reader(os.path.basename(f)[:-3])
import gea_torch.serve, gea_torch.train.dispatch, gea_torch.train.runner
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""
    done = subprocess.run([sys.executable, "-c", code, benchcopy.ROOT], capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    tops = set(done.stdout.split())
    assert "portbench" in tops and "gea_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN
