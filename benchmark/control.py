"""The control of a cell at its own size, on the seeds given: the
reference with a guarantee broken in the program's place (the `control`
of the cell's traffic module), one JSON line of its compared numbers per seed,
each beside the cell's limit. Every line has to exceed a limit.

    python3 benchmark/control.py --workload <cell> --seed <n> [--seed ...]

Needs a CUDA card; the benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None, device: str = "cuda", root: str = ROOT, out=None) -> int:
    out = out or sys.stdout
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    if root not in sys.path:
        sys.path.insert(0, root)
    import torch
    from benchmark.run import Cell
    if device == "cuda" and not torch.cuda.is_available():
        print("the control needs a CUDA card", file=sys.stderr)
        return 2
    cell = Cell(root, args.workload)
    driver = cell.driver()
    limits = cell.workload["limits"]
    failed_all = True
    for seed in args.seed:
        t0 = time.perf_counter()
        got = driver.control(cell, seed, torch.device(device))
        fails = {n: v for n, v in got.items()
                 if n in limits and v > limits[n]}
        failed_all &= bool(fails)
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              readings=got, limits=limits,
                              fails=sorted(fails),
                              seconds=time.perf_counter() - t0)),
              file=out, flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
