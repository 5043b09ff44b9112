"""Data-parallel sharding over a 1-D mesh of devices.

The chunk batch is split over the mesh; each device encodes or decodes its
lanes as independent DEFLATE block runs, the per-device Adler-32 states
are exchanged with one all-gather (NCCL between cards, gloo between CPU
processes) and folded in mesh order with the associative combine, and
``assemble_ragged`` concatenates the lanes' bytes on the device.  The
outputs equal those of ``tpu_deflate.parallel.shard`` element for element.

The mesh is the devices that this process drives, in order, and, when
``torch.distributed`` is initialized, the default process group.  The
global mesh is (rank, local device) in rank-major order: a global batch is
split evenly over it, and each process returns the rows of its own
devices, as a JAX host holds only its addressable shards.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from tpu_deflate_torch.config import DeflateConfig
from tpu_deflate_torch.ops.checksum import adler32_fold_states, adler32_state
from tpu_deflate_torch.ops.decode import decode_rows_batch
from tpu_deflate_torch.ops.encode import encode_blocks_batch
from tpu_deflate_torch.ops.header import CL_WIN

# bytes a lane may read past its end bit: the last stored block's LEN,
# NLEN and payload, and a dynamic header's code lengths; the JAX lanes read
# them from the shared stream
_READ_PAST = 4 + 0xFFFF + CL_WIN // 8 + 16


class Mesh:
    """A 1-D mesh: ``devices``, the devices this process drives in mesh
    order (a device may be listed more than once), and ``group``, the
    process group joining the processes, or None in one process."""

    def __init__(self, devices, axis: str = "dp", group=None):
        self.devices = tuple(devices)
        self.axis = axis
        self.group = group
        self.rank = 0 if group is None else dist.get_rank(group)
        self.world = 1 if group is None else dist.get_world_size(group)

    @property
    def size(self) -> int:
        """Devices in the global mesh."""
        return self.world * len(self.devices)

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}, axis={self.axis!r}, "
                f"rank={self.rank}, world={self.world})")


@dataclasses.dataclass(frozen=True)
class ShardedBatch:
    """This process's rows of a global batch of ``rows`` rows: one tensor
    a local device of the mesh, on that device, in mesh order."""

    shards: tuple
    rows: int

    @property
    def shape(self) -> tuple:
        return (self.rows, *self.shards[0].shape[1:])


def make_mesh(devices=None, axis: str = "dp") -> Mesh:
    """A mesh over ``devices``, joined by the default process group where
    ``torch.distributed`` is initialized.  By default the devices this
    process owns: under an NCCL group the card it has set (one rank a
    card), under a gloo group the CPU, and in one process every visible
    CUDA card.  Raises RuntimeError where that is a card and none is
    visible."""
    group = None
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if devices is None:
        if group is not None and dist.get_backend(group) == "gloo":
            devices = ["cpu"]
        elif torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible")
        elif group is not None:
            devices = [torch.device("cuda", torch.cuda.current_device())]
        else:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d for d in devices]
    kinds = {d.type for d in devices}
    if len(kinds) != 1 or not kinds <= {"cuda", "cpu"}:
        raise ValueError(f"make_mesh: needs CUDA devices or the CPU, not {kinds}")
    if group is not None:
        want = "nccl" if devices[0].type == "cuda" else "gloo"
        if dist.get_backend(group) != want:
            raise ValueError(f"make_mesh: {devices[0].type} devices need the "
                             f"{want} backend, not {dist.get_backend(group)}")
    return Mesh(devices, axis, group)


def _check_axis(mesh: Mesh, axis: str) -> None:
    if axis != mesh.axis:
        raise ValueError(f"axis {axis!r} is not the mesh's axis {mesh.axis!r}")


def _on(device: torch.device):
    """The context in which kernels for ``device`` launch."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def as_tensor(x) -> torch.Tensor:
    """x as a tensor: a tensor as it is, an array without a copy unless it
    is read-only (as ``np.frombuffer`` of bytes is)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _local_rows(x, mesh: Mesh) -> list:
    """This process's rows of x, one piece a local device, where they lie:
    x is a global batch (split evenly over the global mesh, rank-major) or
    a ``ShardedBatch``.  Raises ValueError where the rows do not divide
    evenly (the JAX package's type)."""
    if isinstance(x, ShardedBatch):
        if len(x.shards) != len(mesh.devices):
            raise ValueError(f"{len(x.shards)} shards for {len(mesh.devices)} "
                             f"local devices")
        return list(x.shards)
    x = as_tensor(x)
    if x.shape[0] % mesh.size:
        raise ValueError(f"a batch of {x.shape[0]} rows does not divide evenly "
                         f"over the mesh of {mesh.size} devices")
    per = x.shape[0] // mesh.size
    first = mesh.rank * len(mesh.devices)
    return [x[(first + i) * per : (first + i + 1) * per]
            for i in range(len(mesh.devices))]


def _local_shards(x, mesh: Mesh) -> list:
    """``_local_rows`` moved each to its device."""
    return [r.to(d) for r, d in zip(_local_rows(x, mesh), mesh.devices)]


def _adler_fold(a: torch.Tensor, b: torch.Tensor, lens: torch.Tensor):
    """Per-chunk (a, b, len) Adler states folded in order into one triple
    of 0-dim int64 tensors on their device (the JAX package's scan; the
    combine, ``adler32_pair_combine``, is associative, so the fold runs as
    an ordered tree)."""
    return adler32_fold_states(a, b, lens)


def assemble_ragged(chunks: torch.Tensor, sizes: torch.Tensor, total_cap: int):
    """Ordered ragged concat on the device: uint8[B, M] and sizes int32[B]
    -> (uint8[total_cap], total int32), zero past total."""
    B, M = chunks.shape
    sizes = sizes.to(torch.int64)
    offs = torch.cumsum(sizes, 0) - sizes  # exclusive
    total = sizes.sum()
    j = torch.arange(total_cap, device=chunks.device)
    owner = (torch.searchsorted(offs, j, right=True) - 1).clamp(0, B - 1)
    within = (j - offs[owner]).clamp(0, M - 1)
    val = chunks[owner, within]
    return torch.where(j < total, val, 0).to(torch.uint8), total.to(torch.int32)


def _gather_states(triples: list, mesh: Mesh) -> torch.Tensor:
    """int64[mesh.size, 3]: every device's folded (a, b, len), in mesh
    order; across processes by one all-gather on the first local device."""
    home = mesh.devices[0]
    local = torch.stack([t.to(home) for t in triples])
    if mesh.group is None:
        return local
    out = torch.empty(mesh.world * local.shape[0], 3, dtype=torch.int64,
                      device=home)
    dist.all_gather_into_tensor(out, local.contiguous(), group=mesh.group)
    return out


def encode_sharded(data, lengths, finals, mesh: Mesh,
                   config: DeflateConfig = DeflateConfig(), axis: str = "dp"):
    """DP-sharded batch encode: data uint8[B, C], lengths int32[B], finals
    bool[B], global batches or ``ShardedBatch``es, with B divisible by the
    mesh's size.  Returns (out uint8[b, M], sizes int32[b], adler) for this
    process's b rows, on the mesh's first local device; adler is a 0-dim
    int64 tensor, the Adler-32 of all B lanes' data in order.

    Every device's encode is enqueued before anything is read back."""
    _check_axis(mesh, axis)
    parts = [_local_shards(x, mesh) for x in (data, lengths, finals)]
    outs, sizes, triples = [], [], []
    for dev, d, n, f in zip(mesh.devices, *parts):
        with _on(dev):
            n = n.to(torch.int32)
            out, size, _ = encode_blocks_batch(d, n, f.to(torch.bool), config)
            a, b = adler32_state(d, n)
            triples.append(torch.stack(_adler_fold(a, b, n)))
        outs.append(out)
        sizes.append(size)
    fa, fb, _ = _adler_fold(*_gather_states(triples, mesh).unbind(1))
    home = mesh.devices[0]
    return (torch.cat([o.to(home) for o in outs]),
            torch.cat([s.to(home) for s in sizes]), (fb << 16) | fa)


def _lane_rows(src: torch.Tensor, starts: np.ndarray, ends: np.ndarray,
               tail: int):
    """Each lane's rows of the stream src uint8[M] on its device, cut at
    the byte of its start bit, with tail = src's last byte: (rows, stored
    rows or None, end bits and start bits in the row, int32).  The rows
    reach as far past the end bit as a lane can read, so that a lane reads
    what it would read in the whole stream, zeros past its end.  A stored
    copy reads the stream's last byte there instead (the JAX package's
    clamped gather; a stored LEN may run past the stream with no error):
    where a row reaches past a stream that does not end in 0, the stored
    rows are that view, else None (the rows)."""
    M = src.shape[0]
    sb = np.minimum(starts >> 3, M)
    live = ends > starts
    reach = np.where(live, np.minimum(M, -(-ends // 8) + _READ_PAST) - sb, 1)
    W = max(int(reach.max(initial=1)), 1)
    dev = src.device
    sbt = torch.as_tensor(sb, device=dev)
    zeros = torch.zeros(W, dtype=torch.uint8, device=dev)
    rows = torch.cat([src, zeros]).unfold(0, W, 1)[sbt]
    stored = None
    if tail and (sb + W > M).any():
        stored = torch.cat([src, src[-1:].expand(W)]).unfold(0, W, 1)[sbt]
    # a lane that ends at or before its start decodes nothing, as at bit 0
    end_rel = np.where(live, ends - 8 * sb, 0)
    start_rel = np.where(live, starts - 8 * sb, 0)
    i32 = torch.int32
    return (rows, stored, torch.as_tensor(end_rel, dtype=i32, device=dev),
            torch.as_tensor(start_rel, dtype=i32, device=dev))


def decode_sharded(data, start_bits, end_bits, mesh: Mesh, chunk_out_size: int,
                   axis: str = "dp", static_only: bool = False):
    """DP-sharded chunk-parallel decode: data uint8[M], the whole stream on
    every process; lane i decodes from bit start_bits[i] to end_bits[i]
    and stops at its first end-of-block.  start_bits and end_bits are
    global batches or ``ShardedBatch``es whose length divides evenly over
    the mesh.  Returns (out uint8[b, chunk_out_size], totals int32[b],
    errs int32[b]) for this process's b lanes, on the mesh's first local
    device.  ``static_only`` decodes stored and static blocks only.

    Each device gets its lanes' rows of the stream and decodes them with
    ``decode_rows_batch``; a start bit need not be a multiple of 8.
    Raises ValueError for a start bit below 0 or an end bit past the
    stream, which the JAX package reads as garbage."""
    _check_axis(mesh, axis)
    src = as_tensor(data).reshape(-1).to(torch.uint8)
    M = src.shape[0]
    if M == 0:
        raise ValueError("decode_sharded: empty stream")
    starts = [s.cpu().numpy().astype(np.int64) for s in _local_rows(start_bits, mesh)]
    ends = [e.cpu().numpy().astype(np.int64) for e in _local_rows(end_bits, mesh)]
    for s, e in zip(starts, ends):
        if (s < 0).any() or (e > 8 * M).any():
            raise ValueError("decode_sharded: start bits must be >= 0 and end "
                             f"bits at most {8 * M}, the stream's end")
    tail = int(src[-1])
    tok_cap = chunk_out_size + 16
    copies, results = {}, []
    for dev, s, e in zip(mesh.devices, starts, ends):
        with _on(dev):
            if dev not in copies:
                copies[dev] = src.to(dev)
            rows, stored, end_rel, start_rel = _lane_rows(copies[dev], s, e, tail)
            results.append(decode_rows_batch(
                rows, end_rel, chunk_out_size, tok_cap, static_only,
                starts=start_rel, stored_rows=stored))
    home = mesh.devices[0]
    return tuple(torch.cat([r[k].to(home) for r in results]) for k in range(3))
