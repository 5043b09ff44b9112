"""The payloads: cuts of the repository's pinned corpus, placed by the seed.

The corpus (``tests/data/corpus.bin.gz``: Python standard-library sources,
a shared object and documentation, 10 MiB) is read as a ring.  A mix of
``payloads`` cuts of ``payload_bytes`` starts them ``len / payloads``
bytes apart from an offset drawn from the seed, a multiple of ``align``.
Where ``payload_bytes`` is ``(payloads - 1) / payloads`` of the ring, as
in the 8 MiB mixes, every byte of the corpus lies in the same number of
cuts whatever the seed; where ``align`` is the chunk size too, every cut
is the same chunks of the corpus, so a round of the payloads is the same
lanes on every seed, in another order and with other neighbours.
"""

from __future__ import annotations

import gzip
import hashlib
import random

from portbench.manifest import ROOT

CORPUS = ROOT / "tests" / "data" / "corpus.bin.gz"
CORPUS_SHA = "849e6293c67ab78bf5854ce09a7b27168557ca47b4e2603a50ef6c129f363d41"


def load_corpus() -> bytes:
    with open(CORPUS, "rb") as f:
        data = gzip.decompress(f.read())
    if hashlib.sha256(data).hexdigest() != CORPUS_SHA:
        raise RuntimeError(f"{CORPUS}: sha256 differs from the pinned corpus")
    return data


def payloads(seed: int, payload_bytes: int, count: int, align: int = 1,
             corpus: bytes | None = None) -> list:
    """``count`` distinct cuts of ``payload_bytes`` of the corpus ring."""
    corpus = corpus if corpus is not None else load_corpus()
    n = len(corpus)
    ring = corpus * (1 + -(-payload_bytes // n))
    start = random.Random(f"payloads-{seed}").randrange(n // align) * align
    step = n // count
    offsets = [(start + j * step) % n for j in range(count)]
    return [ring[o : o + payload_bytes] for o in offsets]
