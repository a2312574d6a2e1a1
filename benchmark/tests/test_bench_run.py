"""CPU rehearsals of whole runs at tiny sizes: a cell added as data files
only runs, the last line has the contract's keys, a traced run reads the
per-layer metrics, and nothing of JAX or the JAX package is loaded."""

import io
import json
import os
import subprocess
import sys

import pytest

from benchmark import run

from conftest import ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def run_cell(root, cell, seed=20261017, trace=0, seconds=1):
    out = io.StringIO()
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], device="cpu",
                  root=root, out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["tiny31", "tiny63"])
def test_added_workload_file_runs(tiny_root, cell):
    res = run_cell(tiny_root, cell, seed=2**31 + 99)
    assert list(res)[:5] == KEYS[:5] and list(res)[-1] == "checks"
    assert set(res) == set(KEYS)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"setup_s", "build_kmers_per_s",
                                   "query_kmers_per_s",
                                   "peak_bytes_per_kmer"}
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


def test_traced_run_reads_per_layer_metrics(tiny_root):
    res = run_cell(tiny_root, "tiny31", trace=1)
    assert res["correct"] is True and res["attempted"] >= 2
    # on the CPU no device activity: only the span and counter readers
    assert set(res["metrics"]) == {"insert_ms", "finalize_ms",
                                   "arena_bytes_per_kmer"}
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_jax_and_no_card_exit(tiny_root):
    code = (
        "import sys, io\n"
        f"sys.path.insert(0, {tiny_root!r})\n"
        "from benchmark import run\n"
        "rc = run.main(['--workload', 'tiny31', '--seed', '5', '--seconds',"
        " '0', '--trace', '0'], device='cpu', root=" + repr(tiny_root)
        + ", out=io.StringIO())\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'brisk_tpu')]\n"
        "print(rc, bad)\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=600)
    assert p.stdout.strip().splitlines()[-1] == "0 []", p.stderr[-2000:]
    # the command line asks for a card: none here, so exit 2, no result
    p = subprocess.run([sys.executable, os.path.join(tiny_root, "benchmark",
                                                     "run.py"),
                        "--workload", "tiny31", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], capture_output=True,
                       text=True, env=env, timeout=600)
    assert p.returncode == 2 and p.stdout == ""


def test_no_result_without_the_program(tmp_path):
    import shutil
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    str(tmp_path / "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), str(tmp_path))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "k31-chr1-count", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=600)
    assert p.returncode != 0 and p.stdout == ""
