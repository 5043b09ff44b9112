"""tpu_deflate_torch: the tpu_deflate DEFLATE codec on PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

Stage by stage the port of ``tpu_deflate`` (JAX): the same configuration,
the same streams byte for byte.  Tensors on a CUDA device run the kernels
in ``csrc/``; tensors on the CPU run each kernel's plain PyTorch version.

Quick start::

    import zlib
    from tpu_deflate_torch import (DEFAULT, compress_indexed, decompress,
                                   decompress_indexed)

    stream, index = compress_indexed(data, DEFAULT, device="cuda")
    assert decompress_indexed(stream, index, DEFAULT, device="cuda") == data
    assert decompress(zlib.compress(data, 6), device="cuda") == data
"""

from tpu_deflate_torch.api import (
    compress,
    compress_indexed,
    decompress,
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

__all__ = [
    "DeflateConfig",
    "DeflateError",
    "DEFAULT",
    "DECOMPRESS_ONLY",
    "FAST_CONFIG",
    "FULL_WINDOW",
    "LOWLUT",
    "REFERENCE_PARITY",
    "compress",
    "compress_indexed",
    "decompress",
    "decompress_indexed",
]
