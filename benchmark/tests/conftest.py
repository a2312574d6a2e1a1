"""Fixtures of the benchmark's CPU tests: the repository root on the
path, a copy of the benchmark with tiny cells, and the card check of the
tests marked `cuda` (made inside a fixture, never at import)."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# name -> (configuration it shrinks, its cell)
TINY = {"tiny31": ("counter-k31", "k31-chr1-count"),
        "tiny63": ("counter-k63", "k63-hifi-count")}


def make_tiny_copy(dst: str) -> str:
    """A checkout-like copy: BENCHMARK.json and benchmark/ (the port
    linked in), with one tiny cell per configuration added as data
    files only."""
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    os.symlink(os.path.join(ROOT, "brisk_tpu_torch"),
               os.path.join(dst, "brisk_tpu_torch"))
    with open(os.path.join(dst, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, (base, cell) in TINY.items():
        cfg_path = os.path.join(dst, "benchmark", "configs", base + ".json")
        with open(cfg_path) as f:
            cfg = json.load(f)
        cfg["name"] = "tiny-" + base
        cfg["geometry"].update(batch=64, stack=2)
        cfg["enum_geometry"]["lanes"] = 64
        if cfg["index_input"]["kind"] == "genome":
            # chunks longer than a keying piece: the reference stitches
            cfg["index_input"].update(bases=40000, n_per=20000)
        else:
            cfg["index_input"].update(genome_bases=15000, coverage=6,
                                      read_min=1000, read_max=3000)
        with open(os.path.join(dst, "benchmark", "configs",
                               cfg["name"] + ".json"), "w") as f:
            json.dump(cfg, f)
        with open(os.path.join(dst, "benchmark", "workloads",
                               cell + ".json")) as f:
            wl = json.load(f)
        wl.update(name=name, config=cfg["name"])
        wl["traffic"].update(query_reads=200)
        with open(os.path.join(dst, "benchmark", "workloads",
                               name + ".json"), "w") as f:
            json.dump(wl, f)
        bench["configs"].append(dict(
            name=cfg["name"], source="a test", reduced=["index_input"],
            file=f"benchmark/configs/{cfg['name']}.json", why="a test"))
        bench["workloads"].append(dict(name=name, config=cfg["name"],
                                       traffic="count_job", chips=1,
                                       why="a test"))
        for m in bench["per_layer"]:
            m["workloads"].append(name)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_copy(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
