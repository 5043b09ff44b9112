"""tpu_deflate_torch: the tpu_deflate DEFLATE codec on PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

Stage by stage the port of ``tpu_deflate`` (JAX): the same configuration,
the same streams byte for byte.  Tensors on a CUDA device run the kernels
in ``csrc/``; tensors on the CPU run each kernel's plain PyTorch version.

Quick start::

    import gzip, zlib
    from tpu_deflate_torch import (DEFAULT, StreamDecompressor,
                                   compress_gzip_members, compress_indexed,
                                   decompress, decompress_gzip,
                                   decompress_indexed)

    stream, index = compress_indexed(data, DEFAULT, device="cuda")
    assert decompress_indexed(stream, index, DEFAULT, device="cuda") == data
    assert decompress(zlib.compress(data, 6), device="cuda") == data
    members = compress_gzip_members(data, DEFAULT, device="cuda")
    assert decompress_gzip(members, DEFAULT, device="cuda") == data
    assert decompress_gzip(gzip.compress(data), device="cuda") == data
    d = StreamDecompressor(DEFAULT, device="cuda")
    z = zlib.compress(data, 6)
    out = b"".join(d.decompress(z[i : i + 65536])
                   for i in range(0, len(z), 65536))
    assert out + d.flush() == data
"""

from tpu_deflate_torch.api import (
    StreamCompressor,
    StreamDecompressor,
    compress,
    compress_gzip,
    compress_gzip_members,
    compress_indexed,
    decompress,
    decompress_gzip,
    decompress_indexed,
)
from tpu_deflate_torch.config import (
    DECOMPRESS_ONLY,
    DEFAULT,
    FAST_CONFIG,
    FULL_WINDOW,
    LOWLUT,
    REFERENCE_PARITY,
    DeflateConfig,
)
from tpu_deflate_torch.ref.inflate import DeflateError

__version__ = "0.1.0"

__all__ = [
    "DeflateConfig",
    "DeflateError",
    "DEFAULT",
    "DECOMPRESS_ONLY",
    "FAST_CONFIG",
    "FULL_WINDOW",
    "LOWLUT",
    "REFERENCE_PARITY",
    "StreamCompressor",
    "StreamDecompressor",
    "compress",
    "compress_gzip",
    "compress_gzip_members",
    "compress_indexed",
    "decompress",
    "decompress_gzip",
    "decompress_indexed",
    "__version__",
]
