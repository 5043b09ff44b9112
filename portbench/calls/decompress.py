"""``decompress(stream, config)``: each call decompresses one whole zlib
stream, written by stock zlib at the mix's ``level`` from one payload,
and ends with the bytes on the host, as users call it.

Set-up makes the streams with stock zlib (``zlib.compress(payload,
level)``), the producer the configuration states.  A call's shape for the
roofline counts is the benchmark's own reading of its stream
(``blocks.walk``), made once a payload, after the window.  The judged
numbers:

  bytes_bad  answers, equal ones judged once, that differ from their
             payload
  ref_bad    streams whose plain reference inflate (``reference.
             inflate_lane`` on the body, then ``reference.adler32``
             against the trailer) does not give the payload: the traffic
             is what the configuration says
  ratio      the streams' bytes over the payloads' bytes, against the
             configuration's ``limits.ratio``: streams of another level
             read here
  corrupt_accepted
             of two corrupt copies of the first stream, one with its
             Adler-32 trailer flipped and one cut 9 bytes short, those
             that ``decompress`` returns from instead of raising the
             program's ``DeflateError``: the trailer is verified and a
             corrupt stream raises

Whether the program decoded the streams by its device-paced walk or fell
back to its general pipeline does not change the answers, and is not
judged; the traced run's ``foreign.fallbacks_per_call`` reads it.
"""

import hashlib
import zlib

from portbench import blocks
from portbench.reference import InflateError, adler32, inflate_lane

SPAN = "api.decompress"
KIND = "decode"


class Call:
    def __init__(self, mix: dict, config, program, payloads: list):
        self.config, self.program, self.payloads = config, program, payloads
        self.streams = [zlib.compress(p, mix["level"]) for p in payloads]
        self._shapes = {}

    def one(self, i: int):
        answer = self.program.decompress(self.streams[i], self.config)
        return answer, len(self.payloads[i]), len(self.streams[i])

    def shape(self, i: int, answer) -> dict:
        if i not in self._shapes:
            s = self.streams[i]
            self._shapes[i] = blocks.shape([blocks.walk(s[2:-4])], len(self.payloads[i]), len(s))
        return self._shapes[i]

    def judge(self, window, config: dict) -> dict:
        distinct = {}
        for p, answer in [*window.sample, *window.last.items()]:
            distinct.setdefault((p, hashlib.sha256(answer).hexdigest()), (p, answer))
        bytes_bad = sum(answer != self.payloads[p] for p, answer in distinct.values())
        return {"bytes_bad": (bytes_bad, 0),
                "ref_bad": (sum(not _reference_ok(s, p)
                                for s, p in zip(self.streams, self.payloads)), 0),
                "ratio": (sum(map(len, self.streams)) / sum(map(len, self.payloads)),
                          config["limits"]["ratio"]),
                "corrupt_accepted": (sum(not self._raises(s) for s in _corrupt(self.streams[0])),
                                     0)}

    def _raises(self, stream: bytes) -> bool:
        try:
            self.program.decompress(stream, self.config)
        except Exception as e:  # the program's own error, by name
            return any(c.__name__ == "DeflateError" for c in type(e).__mro__)
        return False


def _corrupt(stream: bytes) -> list:
    """The stream with its trailer's last byte flipped, and cut short."""
    return [stream[:-1] + bytes([stream[-1] ^ 0x01]), stream[:-9]]


def _reference_ok(stream: bytes, payload: bytes) -> bool:
    try:
        got = inflate_lane(stream[2:-4])
    except InflateError:
        return False
    return (got.data == payload and got.final
            and adler32(got.data) == int.from_bytes(stream[-4:], "big"))
