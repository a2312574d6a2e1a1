"""BENCHMARK.json and the files it names: every configuration, cell and
metric loads by name, and every field keeps to the contract's form."""

import json
import os
import re

import pytest

from benchmark import run

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 << 10


@pytest.mark.parametrize("cfg", [c["name"] for c in bench()["configs"]])
def test_config_file(cfg):
    entry = [c for c in bench()["configs"] if c["name"] == cfg][0]
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith("benchmark/configs/")
    with open(os.path.join(ROOT, entry["file"])) as f:
        data = json.load(f)
    assert data["name"] == cfg and data["reduced"] == entry["reduced"]
    assert data["source"] == entry["source"]
    assert 0 < len(entry["source"]) <= 200 and "\n" not in entry["source"]
    assert {"params", "geometry", "index_input", "guarantees",
            "enum_geometry"} <= set(data)


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_loads_by_name(cell):
    c = run.Cell(ROOT, cell)
    assert c.chips == 1
    assert NAME.match(cell) and NAME.match(c.entry["traffic"])
    assert 0 < len(c.entry["why"]) <= 200
    assert c.workload["why"] == c.entry["why"]
    assert hasattr(c.driver(), "job")
    assert {m["name"] for m in c.end_to_end} == {
        "setup_s", "build_kmers_per_s", "query_kmers_per_s",
        "peak_bytes_per_kmer"}
    assert len(c.per_layer) == 10
    for m in c.per_layer:
        assert callable(c.reader(m["name"]))


def test_metrics_form():
    b = bench()
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert 0 < len(m["layer"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
