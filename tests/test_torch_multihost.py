"""The sharded facade across processes: 2 processes x 4 shards of the
port over `torch.distributed` (gloo, on the CPU) — host-major shards,
round-robin record ownership, lockstep flushes, the cross-process window
certificate, repairs delivered to the process's own shards,
per-process checkpoints. On the worker stream of
tests/multihost_worker.py the aggregated counts equal the oracle and
brisk_tpu's single-process facade; on a record that needs repairs, the
oracle. Lookups agree with the oracle, query_file totals with the
facade in one process, and
load_multihost_checkpoint reassembles the same counts. Each worker also
holds the cross-process chain certificate (sharded._chain_exact_sharded)
to pipeline._chain_exact over all lanes. After two insert + finalize
cycles (two bucket-sorted runs per shard), load_multihost_checkpoint
rebuilds every shard's runs, and each sampled get_canonical equals its
value before save and the oracle's count.

This file is also the worker: `python tests/test_torch_multihost.py
<port> <process_id> <num_processes> <out_json> [reload]`."""

import json
import os
import random
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, M, B = 31, 11, 8
GEOMETRY = dict(batch_per_shard=4, window=96, stack=2)


def stream_records():
    """The record stream of tests/multihost_worker.py."""
    rng = random.Random(97)
    return ["".join(rng.choice("ACGT") for _ in range(rng.randint(K, 400)))
            for _ in range(24)]


def repair_records():
    """The record of the repair fixture of tests/test_torch_api.py (its
    windows need exact repairs) and two short records: round-robin
    ownership gives it to process 0, which delivers its repairs to its
    own shards while process 1 joins each delivery empty."""
    rng = random.Random(5)

    def rs(n):
        return "".join(rng.choice("ACGT") for _ in range(n))

    rec = (rs(300) + "ACGTTGCA" * 200 + rs(300) + "AAAAAAAAAAAAC" * 80
           + rs(300))
    return [rec, rs(120), rs(90)]


def cycle_records(cycle: int):
    """Three random 3 kb records per insert + finalize cycle."""
    rng = random.Random(61 + cycle)
    return ["".join(rng.choice("ACGT") for _ in range(3000))
            for _ in range(3)]


def reload_sample(n: int = 120) -> list:
    """n k-mers at fixed positions of the cycles' records."""
    recs = cycle_records(0) + cycle_records(1)
    rng = random.Random(3)
    out = []
    for _ in range(n):
        r = recs[rng.randrange(len(recs))]
        p = rng.randrange(len(r) - K + 1)
        out.append(r[p:p + K])
    return out


def write_fasta(path: str, records) -> str:
    with open(path, "w") as f:
        f.write("".join(f">r{i}\n{r}\n" for i, r in enumerate(records)))
    return path


def _chain_cases_agree(mesh) -> bool:
    """_chain_exact_sharded on this process's lane block equals
    pipeline._chain_exact over every lane, for random end states, replay
    states (mostly equal to the predecessor's end), certificates and
    window-0 lanes, from both chain carries."""
    import torch
    from brisk_tpu_torch.index import pipeline
    from brisk_tpu_torch.ops.minimizer import MinimizerState
    from brisk_tpu_torch.parallel import sharded

    class Em:
        def __init__(self, cert, replay):
            self.cert, self.replay = cert, replay

    margin, lanes = K - 1, 24
    per = lanes // mesh.n_proc
    mine = slice(mesh.pid * per, (mesh.pid + 1) * per)
    for seed in range(12):
        g = torch.Generator().manual_seed(seed)

        def field(f, n):
            x = torch.randint(0, 2, (n,), generator=g)
            return x.bool() if f == 3 else x

        end = MinimizerState(*(field(f, lanes) for f in range(7)))
        prev = MinimizerState(*(field(f, 1)[0] for f in range(7)))
        pred = [torch.cat([p.reshape(1), e[:-1]]) for p, e in zip(prev, end)]
        same = torch.rand(lanes, generator=g) < 0.85
        replay = MinimizerState(*(torch.where(same, p, field(f, lanes))
                                  for f, p in enumerate(pred)))
        cert = torch.rand(lanes, generator=g) < 0.15
        vs = torch.where(torch.rand(lanes, generator=g) < 0.1, margin,
                         margin + 4)
        chain = (prev, torch.tensor(bool(seed % 2)))
        want, want_chain = pipeline._chain_exact(Em(cert, replay), end, vs,
                                                 chain, margin)
        got, got_chain = sharded._chain_exact_sharded(
            Em(cert[mine], MinimizerState(*(r[mine] for r in replay))),
            MinimizerState(*(e[mine] for e in end)), vs[mine], chain,
            margin, mesh)
        if not torch.equal(got, want[mine]):
            return False
        for a, b in zip(list(got_chain[0]) + [got_chain[1]],
                        list(want_chain[0]) + [want_chain[1]]):
            if int(a) != int(b):
                return False
    return True


def worker(port: str, pid: int, nproc: int, out_path: str) -> None:
    import torch
    torch.set_num_threads(1)
    from brisk_tpu_torch.params import Parameters
    from brisk_tpu_torch.parallel import multihost
    from brisk_tpu_torch.parallel.facade import ShardedBrisk

    multihost.initialize(f"localhost:{port}", nproc, pid, device="cpu")
    assert multihost.process_count() == nproc
    chain_ok = _chain_cases_agree(multihost.global_mesh(8, "cpu"))

    out = {"process": pid, "chain_ok": chain_ok}
    ckpt_dir = os.path.dirname(os.path.abspath(out_path))
    for name, records in (("stream", stream_records()),
                          ("repair", repair_records())):
        path = write_fasta(f"{out_path}.{name}.fa", records)
        sb = ShardedBrisk(Parameters(K, M, B), n_devices=8, device="cpu",
                          **GEOMETRY)
        assert sb.multihost and sb.n_shards == 8 and sb.n_proc == nproc
        sb.insert_file(path)
        stats = sb.stats()
        agg = {}
        for kv, c in sb.items():  # this process's shards only
            agg[str(kv)] = (agg.get(str(kv), 0) + c) % 256
        out[name] = {
            "shards": sb.my_shards, "n_emitted": stats["nb_emitted"],
            "n_repaired": sb.n_repaired_windows,
            "probe": sb.get_canonical(records[0][:K]),  # collective
            "query_total": sb.query_file(path),           # collective
            "counts": agg}
        sb.save(os.path.join(ckpt_dir, f"ckpt_{name}"))
    with open(out_path, "w") as f:
        json.dump(out, f)
    import torch.distributed as dist
    dist.destroy_process_group()


def reload_worker(port: str, pid: int, nproc: int, out_path: str) -> None:
    """Two insert + finalize cycles across the processes, the sample's
    get_canonical values (collective), then per-process checkpoints."""
    import torch
    torch.set_num_threads(1)
    from brisk_tpu_torch.params import Parameters
    from brisk_tpu_torch.parallel import multihost
    from brisk_tpu_torch.parallel.facade import ShardedBrisk

    multihost.initialize(f"localhost:{port}", nproc, pid, device="cpu")
    sb = ShardedBrisk(Parameters(K, M, B), n_devices=8, device="cpu",
                      **GEOMETRY)
    for c in range(2):
        sb.insert_file(write_fasta(f"{out_path}.cycle{c}.fa",
                                   cycle_records(c)))
        sb.finalize()
    out = {"runs": {str(d): sb._skl_segments[d] for d in sb.my_shards},
           "before": [sb.get_canonical(s) for s in reload_sample()]}
    sb.save(os.path.join(os.path.dirname(os.path.abspath(out_path)),
                         "ckpt_reload"))
    with open(out_path, "w") as f:
        json.dump(out, f)
    import torch.distributed as dist
    dist.destroy_process_group()


def _run_workers(tmp_path, mode: str = ""):
    """Start the 2 workers of `mode`; returns their Popen objects and out
    paths."""
    outs = [str(tmp_path / f"w{i}.json") for i in range(2)]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), port, str(i), "2",
         outs[i]] + ([mode] if mode else []), cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    return procs, outs


def _wait(procs, meanwhile=lambda: None):
    """Run `meanwhile()` while the workers run, then wait for them; kill
    any still running on the way out. Returns what `meanwhile` did."""
    try:
        result = meanwhile()
        for p in procs:
            out, _ = p.communicate(timeout=45)
            assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return result


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo_count_parity(tmp_path):
    import pytest

    from brisk_tpu.parallel.facade import ShardedBrisk as JSharded
    from brisk_tpu.params import Parameters as JParameters
    from brisk_tpu_torch.oracle import pyref
    from brisk_tpu_torch.params import Parameters
    from brisk_tpu_torch.parallel.facade import ShardedBrisk

    def jax_facade_counts():
        """brisk_tpu's single-process facade while the workers run."""
        stream = write_fasta(str(tmp_path / "stream.fa"), stream_records())
        jb = JSharded(JParameters(K, M, B), **GEOMETRY)
        jb.insert_file(stream)
        return jb.counts_dict()

    procs, outs = _run_workers(tmp_path)
    j_counts = _wait(procs, jax_facade_counts)
    results = [json.load(open(o)) for o in outs]
    assert all(r["chain_ok"] for r in results)
    for name, records in (("stream", stream_records()),
                          ("repair", repair_records())):
        res = [r[name] for r in results]
        assert [r["shards"] for r in res] == [[0, 1, 2, 3], [4, 5, 6, 7]]
        path = write_fasta(str(tmp_path / f"{name}.fa"), records)
        exp = pyref.count_fasta(path, K, M)
        agg = {}
        for r in res:
            for kv, c in r["counts"].items():
                agg[int(kv)] = (agg.get(int(kv), 0) + c) % 256
        assert agg == exp, name
        if name == "stream":
            assert agg == j_counts
        else:  # process 0 repaired and delivered to its own shards
            assert res[0]["n_repaired"] > 0 == res[1]["n_repaired"]
        n_kmers = sum(len(s) - K + 1 for s in records)
        assert [r["n_emitted"] for r in res] == [n_kmers, n_kmers]
        v = pyref.str2num(records[0][:K])
        want = exp.get(v, exp.get(pyref.revcomp(v, K)))
        assert [r["probe"] for r in res] == [want, want]
        # the same facade in one process (held to brisk_tpu's by
        # tests/test_torch_facade*.py)
        one = ShardedBrisk(Parameters(K, M, B), n_devices=8, device="cpu",
                           **GEOMETRY)
        one.insert_file(path)
        total = one.query_file(path)
        assert [r["query_total"] for r in res] == [total, total]
        # the per-process checkpoints reassemble in one process
        sb = ShardedBrisk.load_multihost_checkpoint(
            str(tmp_path / f"ckpt_{name}"), device="cpu", **GEOMETRY)
        assert sb.n_shards == 8 and not sb.multihost
        assert {kv: c for kv, c in sb.counts_dict().items() if c} == exp
        assert sb.n_emitted == n_kmers
    with pytest.raises(AssertionError):
        ShardedBrisk.load_multihost_checkpoint(str(tmp_path / "none"),
                                               device="cpu")


def test_multihost_checkpoint_reload_keeps_each_shards_runs(tmp_path):
    """load_multihost_checkpoint after two finalize cycles: every shard's
    runs are rebuilt from its bucket column (the same runs the workers
    held), and every sampled get_canonical equals its value before save
    and the oracle's count."""
    from brisk_tpu_torch.oracle import pyref
    from brisk_tpu_torch.parallel.facade import ShardedBrisk

    procs, outs = _run_workers(tmp_path, "reload")
    _wait(procs)
    results = [json.load(open(o)) for o in outs]
    held = {int(d): [tuple(r) for r in runs]
            for res in results for d, runs in res["runs"].items()}
    assert sorted(held) == list(range(8))
    assert all(len(runs) >= 2 for runs in held.values()), held
    before = results[0]["before"]
    assert results[1]["before"] == before
    sb = ShardedBrisk.load_multihost_checkpoint(
        str(tmp_path / "ckpt_reload"), device="cpu", **GEOMETRY)
    for d in range(8):
        runs = sb._skl_segments[d]
        assert len(runs) >= 2 and runs[-1][1] == held[d][-1][1], (d, runs)
        assert all(a[1] == c[0] for a, c in zip(runs, runs[1:]))
    exp = {}
    for c in range(2):
        path = write_fasta(str(tmp_path / f"c{c}.fa"), cycle_records(c))
        for kv, n in pyref.count_fasta(path, K, M).items():
            exp[kv] = (exp.get(kv, 0) + n) % 256
    got = [sb.get_canonical(s) for s in reload_sample()]
    assert got == before
    for s, c in zip(reload_sample(), got):
        v = pyref.str2num(s)
        assert c == exp.get(v, exp.get(pyref.revcomp(v, K))), s


if __name__ == "__main__":
    main_fn = reload_worker if sys.argv[5:6] == ["reload"] else worker
    main_fn(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
