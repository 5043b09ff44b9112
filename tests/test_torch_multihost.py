"""Two-process run of tpu_deflate_torch's multi-process path on the CPU.

Two real processes, each driving four ``cpu`` entries of the mesh, join
one gloo process group through ``multihost.initialize()`` (the JAX
package's launch variables); each materializes only its half of 8 chunks
of 4096 bytes (``host_shard_bounds``, ``make_global_batch``) and runs the
sharded encode, whose Adler-32 states cross the processes in one
all-gather.  Rank 0 checks the stream with zlib and against the
single-process port's; then each rank encodes again over the default
mesh (``make_mesh()`` after ``initialize``: its one CPU entry in the gloo
group) and must get the same rows.  The worker is this file run as a script:

    python tests/test_torch_multihost.py <process_id> <num_processes> <port>
"""

import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def pair():
    """(return code, stdout, stderr) of each of the two workers."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS",
                        "NUM_PROCESSES", "PROCESS_ID", "LOCAL_RANK")}
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(pid), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost worker timed out")
        outs.append((p.returncode, out.decode(), err.decode()))
    return outs


def test_two_process_encode_roundtrip(pair):
    for rc, out, err in pair:
        assert rc == 0, f"worker failed rc={rc}\nstdout={out}\nstderr={err[-2000:]}"
        assert "MULTIHOST_OK" in out
    assert "stream checked" in pair[0][1]


def test_two_process_default_mesh(pair):
    """make_mesh() and global_mesh() after initialize(device="cpu"): each
    rank drives the CPU once, joined by the gloo group, and the encode
    over that mesh gives the rank the rows it gets over four entries."""
    for pid, (rc, out, err) in enumerate(pair):
        assert f"default mesh checked p{pid}" in out, f"stdout={out}\nstderr={err[-2000:]}"


def _worker(pid: int, nproc: int, port: str) -> None:
    os.environ["COORDINATOR_ADDRESS"] = f"localhost:{port}"
    os.environ["NUM_PROCESSES"] = str(nproc)
    os.environ["PROCESS_ID"] = str(pid)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import zlib

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from tpu_deflate_torch.api import compress
    from tpu_deflate_torch.config import DeflateConfig
    from tpu_deflate_torch.parallel import multihost
    from tpu_deflate_torch.parallel.shard import encode_sharded, make_mesh

    assert multihost.initialize(device="cpu"), "distributed init did not run"
    assert dist.get_world_size() == nproc and dist.get_backend() == "gloo"
    mesh = make_mesh(["cpu"] * 4)
    assert mesh.size == 4 * nproc and mesh.rank == pid, mesh

    cfg = DeflateConfig(window=256, max_match=10, chunk_size=4096)
    chunk, nchunks = cfg.chunk_size, 8
    rng = np.random.default_rng(1951)  # the same corpus in every process
    raw = (b"multihost pod-slice deflate " * 900
           + bytes(rng.integers(0, 256, 8192, dtype=np.uint8)))[: nchunks * chunk]
    chunks = np.frombuffer(raw, np.uint8).reshape(nchunks, chunk)
    lengths = np.full(nchunks, chunk, np.int32)
    finals = np.zeros(nchunks, bool)
    finals[-1] = True

    # each process materializes only its shard of the batch
    lo, hi = multihost.host_shard_bounds(nchunks)
    assert (lo, hi) == (pid * nchunks // nproc, (pid + 1) * nchunks // nproc)
    gdata = multihost.make_global_batch(chunks[lo:hi].copy(), nchunks, mesh)
    glens = multihost.make_global_batch(lengths[lo:hi], nchunks, mesh)
    gfin = multihost.make_global_batch(finals[lo:hi], nchunks, mesh)
    out, sizes, adler = encode_sharded(gdata, glens, gfin, mesh, cfg)
    assert out.shape[0] == hi - lo and int(adler) == zlib.adler32(raw)

    rows = [out[i, : int(sizes[i])].numpy().tobytes() for i in range(out.shape[0])]
    every = [None] * nproc
    dist.all_gather_object(every, rows)
    if pid == 0:
        body = b"".join(b for part in every for b in part)
        stream = b"\x78\x9c" + body + int(adler).to_bytes(4, "big")
        assert zlib.decompress(stream) == raw, "multihost round-trip failed"
        assert stream == compress(raw, cfg, device="cpu"), "differs from one process"
        print("stream checked", flush=True)

    # the default mesh: this rank's one CPU entry, in the gloo group
    for own in (make_mesh(), multihost.global_mesh()):
        assert own.devices == (torch.device("cpu"),) and own.size == nproc, own
        assert own.group is dist.group.WORLD and own.rank == pid, own
    g = [multihost.make_global_batch(x[lo:hi], nchunks, own)
         for x in (chunks, lengths, finals)]
    out1, sizes1, adler1 = encode_sharded(*g, own, cfg)
    assert torch.equal(out1, out) and torch.equal(sizes1, sizes)
    assert int(adler1) == int(adler)
    print(f"default mesh checked p{pid}", flush=True)
    dist.destroy_process_group()
    assert "jax" not in sys.modules
    print(f"MULTIHOST_OK p{pid}", flush=True)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
