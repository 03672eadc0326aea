"""The harness's contract on the CPU: a dry run's last line, discovery of a
new cell from new files alone, and the refusals (no card, no program)."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

import benchcopy

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def tree_digest(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" in d:
                continue
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return benchcopy.make_copy(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("workload,trace", [("tiny-train", 0), ("tiny-train", 1),
                                            ("tiny-filter", 0), ("tiny-filter", 1)])
def test_dry_run_line(copy, workload, trace):
    """The last line has the contract's keys (breakdown only when traced; the
    dry run's own mark and the check numbers last), the cell's metrics, and
    the check's numbers each with its limit."""
    done = benchcopy.dry_run(copy, workload, trace=trace)
    assert done.returncode == 0, done.stderr[-3000:]
    line = benchcopy.last_json(done.stdout)
    want = KEYS | {"check", "dry_run"} | ({"breakdown"} if trace else set())
    assert set(line) == want
    assert list(line)[-1] == "check"
    bench = json.load(open(os.path.join(copy, "BENCHMARK.json")))
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in bench[kind] if workload in m.get("workloads", [workload])}
    got = set(line["metrics"])
    assert got <= names
    if not trace:
        assert got == names
    assert line["attempted"] > 0 and line["failed"] == 0
    for n in line["check"].values():
        assert set(n) == {"value", "limit"}
    assert "portbench correct =" in done.stderr


def test_new_cell_from_new_files_only(tmp_path):
    """A configuration, a mix of an existing loop and a metric added as files,
    and a cell and a metric added as entries, run with no existing file
    edited."""
    copy = benchcopy.make_copy(str(tmp_path))
    pb = os.path.join(copy, "portbench")
    before = tree_digest(pb)
    flags = dict(benchcopy.TINY, num_features=4, max_features=16)
    benchcopy.write(os.path.join(pb, "configs", "tinier.json"), {"name": "tinier", "flags": flags})
    mix = json.load(open(os.path.join(pb, "mixes", "tinytrain.json")))
    mix["flags"]["steps_per_dispatch"] = 3
    benchcopy.write(os.path.join(pb, "mixes", "tinytrain3.json"), mix)
    with open(os.path.join(pb, "metrics", "steps_seen.train.py"), "w") as f:
        f.write("def read(run):\n    return run.counts.get('steps')\n")
    bench = json.load(open(os.path.join(copy, "BENCHMARK.json")))
    bench["configs"].append({"name": "tinier", "source": "tests",
                             "file": "portbench/configs/tinier.json", "reduced": [],
                             "why": "tests"})
    bench["workloads"].append({"name": "tinier-train3", "config": "tinier",
                               "traffic": "tinytrain3", "chips": 1, "why": "tests"})
    for m in bench["end_to_end"]:
        if "tiny-train" in m.get("workloads", []):
            m["workloads"].append("tinier-train3")
    bench["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "chunked dispatch",
                               "moves": "train_images_per_s", "workloads": ["tinier-train3"]})
    benchcopy.write(os.path.join(copy, "BENCHMARK.json"), bench)
    after = tree_digest(pb)
    assert {k: v for k, v in after.items() if k in before} == before
    done = benchcopy.dry_run(copy, "tinier-train3", trace=1)
    assert done.returncode == 0, done.stderr[-3000:]
    line = benchcopy.last_json(done.stdout)
    assert line["metrics"]["steps_seen.train"]["value"] > 0
    assert line["metrics"]["steps_seen.train"]["value"] % 3 == 0


def test_refuses_without_a_card(copy):
    """The command itself, on a host without CUDA: non-zero, no result."""
    done = subprocess.run([sys.executable, "portbench/run.py", "--workload", "glis80-train",
                           "--seed", "2147483713", "--seconds", "1", "--trace", "0"],
                          cwd=copy, capture_output=True, text=True, timeout=300,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert done.returncode != 0
    assert done.stdout.strip() == ""


def test_refuses_without_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and portbench/: non-zero, no
    result, whatever the host."""
    shutil.copytree(os.path.join(benchcopy.ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(benchcopy.ROOT, "BENCHMARK.json"), tmp_path)
    code = ("import sys; sys.path[:0] = [%r]\n"
            "from portbench import harness\n"
            "sys.exit(harness.main(['--workload', 'glis80-train', '--seed', '1', '--seconds', '1',"
            " '--trace', '0'], device='cpu'))" % str(tmp_path))
    done = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert done.returncode != 0
    assert done.stdout.strip() == ""
