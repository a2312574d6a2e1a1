"""Process layout and collectives of the sharded index (port of
brisk_tpu.parallel.multihost).

`brisk_tpu` runs one shard per device on a `jax.sharding.Mesh` and lets
XLA insert the collectives. Here a shard is a slice of a leading shard
axis of tensors on one device, and a `Mesh` says which contiguous block
of shards this process owns:

    one process      every shard on one device (e.g. 8 shards on one
                     card, or on the CPU for the tests); the collectives
                     are local tensor ops, no process group
    several          `torch.distributed` (gloo for CPU tensors, nccl for
                     CUDA), host-major: process p owns shards
                     [p*n_local, (p+1)*n_local), so a process's lanes
                     are its own slice of the global batch

Collectives:

    exchange(buf, mesh)      lax.all_to_all(split_axis=0, concat_axis=0,
                             tiled=True) over the shard axis: buf
                             (n_local, n_shards, cap, WR) by source shard
                             and destination -> (n_local, n_shards*cap,
                             WR) by destination, sources in global order
    psum(x, mesh)            sum over every shard of every process
    gather(x, mesh)          (n_proc, ...) stack of one tensor per process
    process_max / process_sum  host ints across processes (identity in
                             one process)

`brisk_tpu`'s `make_global`, `lane_sharded`, `lane_block` and `replicate`
have no counterpart: each process simply holds its own block tensors.
Not ported: `sharded_empty_global`, `shard_batch` and `local_entries`
(the per-k-mer `IndexState` programs only brisk_tpu's tests call).
"""

from typing import List

import torch


class Mesh:
    """The shard axis of the index as seen from this process."""

    def __init__(self, n_shards: int, device, n_proc: int = 1, pid: int = 0,
                 group=None):
        if n_shards % n_proc:
            raise ValueError(f"{n_shards} shards do not split over "
                             f"{n_proc} processes")
        self.n_shards = n_shards
        self.device = torch.device(device)
        self.n_proc = n_proc
        self.pid = pid
        self.group = group
        self.n_local = n_shards // n_proc
        self.my_shards = list(range(pid * self.n_local,
                                    (pid + 1) * self.n_local))


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, device="cpu") -> None:
    """Join the process group (idempotent per process): nccl when the
    index lives on a CUDA card, gloo on the CPU. `coordinator_address`
    is host:port of process 0."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def process_count() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def global_mesh(n_shards: int, device) -> Mesh:
    """Host-major mesh of n_shards over every process of the group."""
    import torch.distributed as dist
    return Mesh(n_shards, device, n_proc=dist.get_world_size(),
                pid=dist.get_rank(), group=dist.group.WORLD)


def exchange(buf: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """All-to-all over the shard axis. buf (n_local, n_shards, cap, WR):
    row block [s, d] goes from local source shard s to shard d. Returns
    (n_local, n_shards*cap, WR): local shard d's received blocks from
    global source shards 0, 1, ... in order."""
    n_local, n_shards, cap, WR = buf.shape
    if mesh.group is None:
        return buf.transpose(0, 1).reshape(n_shards, n_shards * cap, WR)
    import torch.distributed as dist
    # destination-major, so process q's block is contiguous: (n_proc,
    # n_local_dst, n_local_src, cap, WR)
    send = buf.transpose(0, 1).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    recv = recv.reshape(mesh.n_proc, n_local, n_local, cap, WR)
    return recv.transpose(0, 1).reshape(n_local, n_shards * cap, WR)


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum of x over every shard of every process (x holds this
    process's part)."""
    s = x.sum()
    if mesh.group is not None:
        import torch.distributed as dist
        dist.all_reduce(s, group=mesh.group)
    return s


def gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(n_proc, *x.shape): x of every process, in process order."""
    if mesh.group is None:
        return x[None]
    import torch.distributed as dist
    parts: List[torch.Tensor] = [torch.empty_like(x)
                                 for _ in range(mesh.n_proc)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.stack(parts)


def _host_reduce(value: int, mesh: Mesh, op_name: str) -> int:
    """value reduced over mesh's processes; identity in one process."""
    if mesh.group is None:
        return int(value)
    import torch.distributed as dist
    dev = "cpu"
    if dist.get_backend(mesh.group) == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=getattr(dist.ReduceOp, op_name), group=mesh.group)
    return int(t.item())


def process_max(value: int, mesh: Mesh) -> int:
    """Max of a per-process host integer across the mesh's processes."""
    return _host_reduce(value, mesh, "MAX")


def process_sum(value: int, mesh: Mesh) -> int:
    """Sum of a per-process host integer across the mesh's processes."""
    return _host_reduce(value, mesh, "SUM")
