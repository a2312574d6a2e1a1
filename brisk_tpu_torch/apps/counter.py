"""k-mer counter CLI on PyTorch — a port of brisk_tpu.apps.counter, the
mirror of the reference demo app (apps/counter.cpp): count a FASTA,
optionally verify (mode 2), query a second FASTA, export KFF, print
stats.

Usage: python -m brisk_tpu_torch.apps.counter -f in.fa -k 31 -m 11 -b 8 \
           [--mode 0|1|2] [-q query.fa] [-o out.kff] [--batch B]
           [--window L] [--device cuda|cpu]

The index lives on --device (default: the first CUDA card; the CLI
exits with an error when there is none).
"""

import argparse
import sys
import time

import torch

from brisk_tpu_torch.api import Brisk
from brisk_tpu_torch.oracle import pyref
from brisk_tpu_torch.params import Parameters


class Counter(Brisk):
    """The counter demo is the Brisk facade with count semantics
    (DATA = uint8-wrapping counts, reference apps/counter.cpp)."""

    def count_file(self, path: str):
        self.insert_file(path)

    def stats(self):
        s = super().stats()
        return dict(nb_buckets=s["nb_buckets"], nb_entries=s["nb_kmers"],
                    nb_superkmers=s["nb_superkmers"],
                    nb_emitted=s["nb_emitted"],
                    largest_bucket=s["largest_bucket_entries"])


def pretty_int(n: int) -> str:
    return f"{n:,}"


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Brisk k-mer counter on PyTorch (reference counter.cpp "
                    "parity)")
    ap.add_argument("-f", "--file", required=True, help="FASTA to count")
    ap.add_argument("-q", "--query", default="", help="FASTA to query")
    ap.add_argument("-k", type=int, default=31)
    ap.add_argument("-m", type=int, default=15)
    ap.add_argument("-b", type=int, default=14)
    ap.add_argument("-o", dest="outfile", default="",
                    help="KFF output file")
    ap.add_argument("-t", "--threads", type=int, default=1,
                    help="accepted for reference-CLI parity; parallelism "
                         "here is device lanes (--batch), not host threads")
    ap.add_argument("--mode", type=int, default=0,
                    help="0: count | 1: perf only | 2: verify vs oracle")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--window", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the index (default: cuda)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card is available "
                         "(pass --device cpu to count on the host)")
    params = Parameters(k=args.k, m=args.m, b=min(args.b, 15))
    print(f"I'm counting {args.file}")
    print(f"Kmer size:\t{params.k}\nMinimizer size:\t{params.m}\n"
          f"Bucket size:     {params.b}")
    print(f"Devices: {_device_name(device)}")

    t0 = time.time()
    counter = Counter(params, batch=args.batch, window=args.window,
                      device=device)
    counter.count_file(args.file)
    int(counter.skl.n_rows)  # completion barrier (data-dependent readback)
    elapsed = time.time() - t0
    print(f"Kmer counted elapsed time: {elapsed:.3f}s")

    if args.mode == 2:
        print("--- Start counting verification ---")
        got = counter.counts_dict()
        exp = pyref.count_fasta(args.file, params.k, params.m)
        if got == exp:
            print("All counts are correct !")
        else:
            extra = {k: v for k, v in got.items() if exp.get(k) != v}
            missing = {k: v for k, v in exp.items() if got.get(k) != v}
            print(f"{len(extra) + len(missing)} errors")
            for kv in list(extra)[:5]:
                print("too many", pyref.num2str(kv, params.k),
                      got[kv], "vs", exp.get(kv, 0))
            for kv in list(missing)[:5]:
                print("missing", pyref.num2str(kv, params.k),
                      got.get(kv, 0), "vs", missing[kv])
            sys.exit(1)

    if args.query:
        t1 = time.time()
        total = counter.query_file(args.query)
        print(f"Query total: {total}")
        print(f"Query elapsed time: {time.time() - t1:.3f}s")

    if args.outfile:
        from brisk_tpu_torch.io import kff
        counter.finalize()
        kff.write_index_skl(args.outfile, counter.skl, params)
        print(f"Index written to {args.outfile} "
              f"(KFF, super-k-mer blocks)")

    if args.mode == 1:
        # perf mode: no host readback of the index beyond what counting
        # already did (the reference's mode 1 only reports timing)
        print(f"kmer / second: "
              f"{pretty_int(int(counter.n_emitted / elapsed))}")
        return

    s = counter.stats()
    print(f"{pretty_int(s['nb_buckets'])} bucket used "
          f"(/{pretty_int(params.n_buckets)} possible)")
    print(f"nb superkmers: {pretty_int(s['nb_superkmers'])}")
    print(f"nb kmers: {pretty_int(s['nb_entries'])}")
    print(f"kmer / second: {pretty_int(int(counter.n_emitted / elapsed))}")
    if s['nb_superkmers']:
        print(f"average kmer / superkmer: "
              f"{s['nb_emitted'] / s['nb_superkmers']:.4f}")
    if s['nb_buckets']:
        print(f"average superkmer / bucket: "
              f"{s['nb_superkmers'] / s['nb_buckets']:.4f}")
    print(f"Largest bucket :\t{pretty_int(s['largest_bucket'])}")
    counter.finalize()
    ss = counter.skl_stats()
    print(f"nb superkmer rows: {pretty_int(ss['nb_superkmer_rows'])}")
    print(f"superkmer arena: {pretty_int(ss['resident_bytes'])} bytes "
          f"({ss['bytes_per_kmer']:.2f} B/kmer resident)")


if __name__ == "__main__":
    main()
