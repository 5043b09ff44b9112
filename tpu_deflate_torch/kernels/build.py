"""Build and load the hand-written CUDA kernels (``csrc/*.cu``, with the
headers ``csrc/*.cuh`` they share).

Each source compiles with its own ``nvcc``, all at once, and the objects
link into one shared library with a plain C interface, bound with
``ctypes``.  The build runs at first use, into
``build/`` at the repository root, under a name that carries a hash of the
sources, so an edited kernel is rebuilt and an unchanged one is loaded as
is.  Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a nonzero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every entry point: pointers and the stream as void*,
# sizes as int (ctypes would otherwise pass a pointer as a 32-bit int).
SIGNATURES = {
    "match2_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "mono_scatter_add_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "mono_compact_launch": [_P, _P, _P, _I, _I, _I, _I, _P],
    "tokenize_static_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _P],
    "expand3_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "tokenize_dyn_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P, _P, _I, _I, _I, _I, _I, _P],
    "resolve_launch": [_P, _P, _P, _P, _I, _I, _P],
    "expand2_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _P],
    "ent_from_phi_launch": [_P, _P, _P, _P, _I, _I, _P],
    "visited_from_adv_launch": [_P, _P, _P, _P, _P, _I, _I, _P],
    "tokenize_hier_k1d_launch": [_P, _I, _P, _P, _P, _P, _I, _P],
    "tokenize_hier_k3d_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 _I, _I, _P],
    "farmatch_keys_launch": [_P, _P, _P, _I, _I, _P],
    "farmatch_prev_launch": [_P, _P, _P, _I, _I, _P],
    "farmatch_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "dyntrees_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> pathlib.Path:
    sources = sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")])
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtpu_deflate_torch_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernels unless a library of the same sources exists."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        nvcc = _nvcc()
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmp, src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        logs = [(p.communicate()[0], p.returncode) for p in procs]
        lib = os.path.join(tmp, "lib.so")
        if all(rc == 0 for _, rc in logs):
            link = subprocess.run([nvcc, "-shared", "-o", lib, *objs],
                                  capture_output=True, text=True)
            logs.append((link.stdout + link.stderr, link.returncode))
        failed = [(out, rc) for out, rc in logs if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"({rc}) {out}" for out, rc in failed))
        os.replace(lib, path)  # atomic: a concurrent loader sees all or nothing
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {code}")


def stream_handle(device):
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require_cuda(name: str, *tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensor on {t.device}, expected cuda")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor is not contiguous")
