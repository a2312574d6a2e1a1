"""The benchmark of brisk_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything is found by name: the cell in BENCHMARK.json and
benchmark/workloads/<cell>.json, its configuration in
benchmark/configs/<config>.json, its traffic driver in
benchmark/traffic/<driver>.py and, with --trace 1, the reader of each
per-layer metric in benchmark/metrics/<metric>.py.

A run generates its inputs from the seed, warms up (set-up, reported as
setup_s), then runs the traffic module's jobs in a closed loop until the first
job boundary at or after --seconds. With --trace 1 the second job of the
window runs under torch.profiler, and the per-layer metrics are read
from its record. After the window the traffic module's check compares the last
job's output, and every job's answers, with the plain reference. The
last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and breakdown with --trace 1), and last the
compared numbers with their limits, which also end standard error.

Needs a CUDA card: without one (or with fewer than the cell's chips) it
exits with 2 and prints no result.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "brisk_tpu")


def load_module(path: str, name: str):
    """Import one file of the benchmark by path."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def safe(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


class Cell:
    """A cell as its files state it: the BENCHMARK.json entry, the
    workload file, the configuration file and the metric entries that
    apply to it."""

    def __init__(self, root: str, name: str):
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            bench = json.load(f)
        entries = [w for w in bench["workloads"] if w["name"] == name]
        if len(entries) != 1:
            raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
        self.entry = entries[0]
        self.dir = os.path.join(root, "benchmark")
        with open(os.path.join(self.dir, "workloads", name + ".json")) as f:
            self.workload = json.load(f)
        if self.workload["config"] != self.entry["config"]:
            raise SystemExit(f"{name}: the workload file names config "
                             f"{self.workload['config']!r}, BENCHMARK.json "
                             f"{self.entry['config']!r}")
        with open(os.path.join(self.dir, "configs",
                               self.entry["config"] + ".json")) as f:
            self.config = json.load(f)
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    def driver(self):
        d = self.workload["driver"]
        return load_module(os.path.join(self.dir, "traffic", d + ".py"),
                           "bench_traffic_" + safe(d))

    def reader(self, metric: str):
        return load_module(os.path.join(self.dir, "metrics", metric + ".py"),
                           "bench_metric_" + safe(metric)).read


def set_cache_dirs(root: str) -> None:
    """Kernel and build caches live at fixed paths inside the checkout.
    The program's own nvcc and g++ builds go to brisk_tpu_torch/_build,
    also inside it."""
    cache = os.path.join(root, "benchmark", "_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device: str = "cuda", root: str = ROOT,
         out=None) -> int:
    """One run. `device` "cpu" skips the look for a card (CPU tests at
    small sizes only); the command line always asks for one."""
    out = out or sys.stdout
    args = parse(argv)
    if root not in sys.path:
        sys.path.insert(0, root)
    cell = Cell(root, args.workload)
    set_cache_dirs(root)
    import torch
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from benchmark import tracing
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    driver = cell.driver()
    state = driver.prepare(cell, args.seed, dev)
    sync()
    peak = [0]

    def read_peak():
        if on_card:
            peak[0] = max(peak[0], torch.cuda.max_memory_allocated())

    jobs = []
    record = None
    t_win = time.perf_counter()
    setup_s = t_win - _T0
    while True:
        traced = args.trace == 1 and len(jobs) == 1
        read_peak()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        if traced:
            res, record = tracing.profiled(
                lambda spans: driver.job(state, spans), dev)
        else:
            res = driver.job(state, tracing.Spans(sync))
        res["peak_bytes"] = (torch.cuda.max_memory_allocated()
                             if on_card else 0)
        jobs.append(res)
        if time.perf_counter() - t_win >= args.seconds and (
                args.trace == 0 or len(jobs) >= 2):
            break
    window_s = time.perf_counter() - t_win
    read_peak()
    leaked = forbidden_modules()
    if leaked:
        print(f"modules loaded in the run: {', '.join(leaked)}",
              file=sys.stderr)
        return 3

    if args.trace:
        record.update(driver.trace_facts(state, jobs))
    for i, j in enumerate(jobs):
        print(f"job {i}: " + ", ".join(
            f"{n} {v:.4f}" for n, v in j.items() if n.endswith("_s")),
            file=sys.stderr)
    t_check = time.perf_counter()
    checks, failed = driver.check(state, jobs)
    print(f"setup {setup_s:.3f} s, window {window_s:.3f} s, {len(jobs)} "
          f"jobs, check {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            v = cell.reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
    else:
        values = driver.metrics(state, jobs, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = dict(value=values[m["name"]],
                                      unit=m["unit"])
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    result = dict(correct=correct, attempted=len(jobs), failed=failed,
                  metrics=metrics, device=tracing.device_info(
                      dev, cell.chips, peak[0]))
    if args.trace:
        result["device"].update(busy_s=record["busy_s"],
                                window_s=record["window_s"])
        result["breakdown"] = record["breakdown"]
    result["checks"] = checks
    leaked = forbidden_modules()
    if leaked:
        print(f"modules loaded in the run: {', '.join(leaked)}",
              file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
