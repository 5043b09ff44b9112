"""The blocks and tokens of a DEFLATE stream, read by the benchmark itself
for the shapes of decode calls (``rooflines/``): a walk of RFC 1951 on the
plain reference's tables (``reference.py``) that decodes every symbol and
builds no output.

``walk(buf)`` reads blocks from bit 0 until a final block or until the
next block would start at or past the end of ``buf``, as
``reference.inflate_lane`` does (with ``stop_at_eob``, until the end of
the first static or dynamic block, where a lane of the indexed decode
stops), and counts

  blocks         stored, static and dynamic blocks (``reference`` order)
  literals       literal symbols; ``matches`` length symbols
  stored_bytes   the bytes of stored blocks
  huffman_bits   bits of the static and dynamic blocks, headers included
  header_bits    bits of the dynamic headers, from a block's first bit to
                 its first symbol
  cl_symbols     code-length symbols of the dynamic headers
  code_lengths   their HLIT + HDIST code lengths

``shape`` sums the counts over a call's lanes into the keys the decode
roofline files read.
"""

from __future__ import annotations

from portbench.reference import (
    _STATIC,
    CL_ORDER,
    DIST_EXTRA,
    DYNAMIC,
    LEN_EXTRA,
    STATIC,
    STORED,
    InflateError,
    _windows,
    decode_table,
)

KEYS = ("literals", "matches", "stored_bytes", "huffman_bits", "header_bits",
        "cl_symbols", "code_lengths")


def walk(buf: bytes, stop_at_eob: bool = False) -> dict:
    """The counts of ``buf``'s blocks; raises InflateError on a stream the
    reference would refuse."""
    try:
        return _walk(buf, stop_at_eob)
    except IndexError:
        raise InflateError("the stream runs past its bytes") from None


def _walk(buf: bytes, stop_at_eob: bool) -> dict:
    W = _windows(buf)
    nbits = 8 * len(buf)
    n = dict.fromkeys(KEYS, 0)
    blocks = [0, 0, 0]
    p = 0
    final = False

    def bits(k):
        nonlocal p
        v = (W[p >> 3] >> (p & 7)) & ((1 << k) - 1)
        p += k
        return v

    while p < nbits and not final:
        first = p
        final = bool(bits(1))
        btype = bits(2)
        if btype == STORED:
            p = (p + 7) & ~7
            size = bits(16)
            p += 16 + 8 * size
            n["stored_bytes"] += size
            blocks[STORED] += 1
            continue
        if btype == STATIC:
            (lt, lb), (dt, db) = _STATIC
        elif btype == DYNAMIC:
            hlit, hdist, hclen = bits(5) + 257, bits(5) + 1, bits(4) + 4
            cl = [0] * 19
            for i in range(hclen):
                cl[CL_ORDER[i]] = bits(3)
            ct, cb = decode_table(cl)
            lengths = []
            while len(lengths) < hlit + hdist:
                e = ct[(W[p >> 3] >> (p & 7)) & ((1 << cb) - 1)]
                if not e:
                    raise InflateError("bad code-length code")
                p += e & 15
                sym = e >> 4
                n["cl_symbols"] += 1
                if sym < 16:
                    lengths.append(sym)
                elif sym == 16:
                    lengths += [lengths[-1]] * (3 + bits(2))
                else:
                    lengths += [0] * (3 + bits(3) if sym == 17 else 11 + bits(7))
            n["code_lengths"] += hlit + hdist
            n["header_bits"] += p - first
            (lt, lb), (dt, db) = decode_table(lengths[:hlit]), decode_table(lengths[hlit:])
        else:
            raise InflateError("block type 3")
        blocks[btype] += 1
        lmask, dmask = (1 << lb) - 1, (1 << db) - 1
        while True:
            e = lt[(W[p >> 3] >> (p & 7)) & lmask]
            if not e:
                raise InflateError("bad literal/length code")
            p += e & 15
            sym = e >> 4
            if sym < 256:
                n["literals"] += 1
                continue
            if sym == 256:
                break
            n["matches"] += 1
            p += LEN_EXTRA[sym - 257]
            e = dt[(W[p >> 3] >> (p & 7)) & dmask] if db else 0
            if not e:
                raise InflateError("bad distance code")
            p += (e & 15) + DIST_EXTRA[e >> 4]
        n["huffman_bits"] += p - first
        if stop_at_eob:
            break
    n["blocks"] = tuple(blocks)
    return n


def shape(lanes: list, raw_bytes: int, stream_bytes: int) -> dict:
    """A decode call's shape from the ``walk`` of each of its lanes:
    ``raw_bytes`` and ``stream_bytes`` as the call's, ``lanes`` their
    number, ``blocks`` by type as {"stored", "static", "dynamic"}, and
    each of ``KEYS`` summed."""
    out = {"lanes": len(lanes), "raw_bytes": raw_bytes, "stream_bytes": stream_bytes,
           "blocks": {k: sum(w["blocks"][t] for w in lanes)
                      for k, t in (("stored", STORED), ("static", STATIC),
                                   ("dynamic", DYNAMIC))}}
    out.update({k: sum(w[k] for w in lanes) for k in KEYS})
    return out
