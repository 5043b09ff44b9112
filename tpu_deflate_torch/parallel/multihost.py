"""Multi-process start-up and per-process batches for ``parallel.shard``.

  * initialize(): ``torch.distributed.init_process_group`` when the launch
    environment names a coordinator (the JAX package's variables, so one
    launch serves both): NCCL on the card, gloo on the CPU
  * global_mesh(): this process's devices joined by the default group
  * host_shard_bounds(): the chunks this process materializes
  * make_global_batch(): those chunks on this process's devices, in the
    form ``encode_sharded`` takes

In one process the mesh is ``parallel.shard.make_mesh``'s.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from tpu_deflate_torch.parallel.shard import (
    Mesh,
    ShardedBatch,
    _check_axis,
    as_tensor,
    make_mesh,
)


def initialize(device="cuda") -> bool:
    """Join the process group that COORDINATOR_ADDRESS (or
    JAX_COORDINATOR_ADDRESS, ``host:port``), NUM_PROCESSES and PROCESS_ID
    describe, with NCCL for ``cuda`` (after ``torch.cuda.set_device`` with
    the local rank: LOCAL_RANK, else PROCESS_ID modulo the visible cards)
    and gloo for ``cpu``.  Returns True where this process is part of a
    multi-process launch."""
    coord = os.environ.get("COORDINATOR_ADDRESS") or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if coord:
        if not dist.is_initialized():
            world = int(os.environ["NUM_PROCESSES"])
            rank = int(os.environ["PROCESS_ID"])
            kind = torch.device(device).type
            if kind == "cuda":
                cards = torch.cuda.device_count()
                if cards == 0:
                    raise RuntimeError("initialize: no CUDA device is visible")
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % cards)))
                backend = "nccl"
            elif kind == "cpu":
                backend = "gloo"
            else:
                raise ValueError(f"initialize: no backend for {kind} devices")
            dist.init_process_group(backend, init_method=f"tcp://{coord}",
                                    world_size=world, rank=rank)
        return True
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def global_mesh(axis: str = "dp") -> Mesh:
    """This process's devices and the default group: ``make_mesh``'s
    default (the card this rank owns under NCCL, the CPU under gloo, every
    visible card in one process)."""
    return make_mesh(axis=axis)


def _rank_world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_shard_bounds(nchunks: int) -> tuple[int, int]:
    """[start, end) of the chunks this process materializes when the
    chunk batch is sharded over the global mesh."""
    pid, pc = _rank_world()
    per = -(-nchunks // pc)
    return min(pid * per, nchunks), min((pid + 1) * per, nchunks)


def make_global_batch(local_chunks, nchunks_global: int, mesh: Mesh,
                      axis: str = "dp") -> ShardedBatch:
    """This process's rows of a global batch of nchunks_global rows, split
    over its local devices and put on them.  Raises ValueError where the
    rows are not this process's share of an even split."""
    _check_axis(mesh, axis)
    x = as_tensor(local_chunks)
    per = nchunks_global // mesh.size
    if per * mesh.size != nchunks_global or x.shape[0] != per * len(mesh.devices):
        raise ValueError(f"{x.shape[0]} local rows are not this process's share "
                         f"of {nchunks_global} over {mesh.size} devices")
    return ShardedBatch(tuple(x[i * per : (i + 1) * per].to(d)
                              for i, d in enumerate(mesh.devices)), nchunks_global)
