"""Static configuration of the codec: feature flags, sizes, legality rules.

The same surface as ``tpu_deflate.config`` (field for field, with the same
presets and the same legality rules), so that one field dict builds both
packages' configs.  The config is read on the host before any tensor work;
disabled features are never reached.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DeflateConfig:
    """Configuration of the codec.

      compress / decompress  enable the encode / decode halves
      dynamic                decode dynamic-Huffman blocks
      match10                maximum match length 10 (else 5)
      fast                   32-byte window matcher
      one_block              one DEFLATE block per stream
      window                 matcher window, 1..32768
      low_lut                decompress-only, minimal tables
      max_match              longest match the encoder emits, 3..258
      chunk_size             bytes per independently encoded chunk
      dynamic_encode         emit dynamic-Huffman blocks when smaller
      lazy                   one-step lazy matching
      far_matcher            "exact" or "fast" matcher for window > 256
    """

    compress: bool = True
    decompress: bool = True
    dynamic: bool = True
    match10: bool = True
    fast: bool = False
    one_block: bool = False
    low_lut: bool = False
    window: int = 256
    max_match: int = 10
    chunk_size: int = 1 << 16
    dynamic_encode: bool = False
    lazy: bool = False
    far_matcher: str = "exact"

    def __post_init__(self):
        if self.low_lut:
            if self.compress or self.dynamic or self.match10 or self.fast:
                raise ValueError(
                    "low_lut excludes compress/dynamic/match10/fast"
                )
            if not self.one_block:
                object.__setattr__(self, "one_block", True)
        if not self.compress and (self.match10 or self.fast):
            raise ValueError("match10/fast require compress")
        if self.fast and self.window > 32:
            object.__setattr__(self, "window", 32)
        if self.window < 1 or self.window > 32768:
            raise ValueError("window must be in [1, 32768]")
        if not self.match10 and self.max_match > 5:
            object.__setattr__(self, "max_match", 5)
        if self.max_match < 3 or self.max_match > 258:
            raise ValueError("max_match must be in [3, 258]")
        if self.far_matcher not in ("exact", "fast"):
            raise ValueError("far_matcher must be 'exact' or 'fast'")


DEFAULT = DeflateConfig()
FAST_CONFIG = DeflateConfig(fast=True, window=32)
REFERENCE_PARITY = DeflateConfig(window=256, max_match=10)
FULL_WINDOW = DeflateConfig(
    window=32768, max_match=258, dynamic_encode=True, lazy=True
)
DECOMPRESS_ONLY = DeflateConfig(
    compress=False, match10=False, fast=False, max_match=258
)
LOWLUT = DeflateConfig(
    compress=False, decompress=True, dynamic=False, match10=False,
    fast=False, one_block=True, low_lut=True, max_match=258,
)
