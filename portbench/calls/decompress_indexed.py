"""``decompress_indexed(stream, index, config)``: each call decompresses
one whole indexed stream, one lane a chunk, and ends with the bytes on the
host, as users call it.

Set-up compresses each payload once with the program's own
``compress_indexed`` at the cell's configuration, then resets the card's
peak memory, so that the run's ``memory_peak_bytes`` is the decode's own
and not the encoder's.  A call's shape for the roofline counts is the
benchmark's own reading of each lane up to its first end-of-block, where
a lane of the indexed decode stops (``blocks.walk``), made once a
payload, after the window.  The judged numbers, after the window:

  bytes_bad  answers, equal ones judged once, that differ from their
             payload
  frames_bad, lanes_bad, ref_lanes_bad, max_dist, max_len
             the streams decoded, judged as the compress cells judge
             their answers (``check.Judge``: the frame, every lane
             through stock zlib and through the plain reference, the
             configuration's window and longest match): the traffic is
             what the configuration says
  ratio      the streams' bytes over the payloads' bytes, against the
             configuration's ``limits.ratio``, as in the compress cells
"""

import hashlib

from portbench import blocks, check

SPAN = "api.decompress_indexed"
KIND = "decode"


class Call:
    def __init__(self, mix: dict, config, program, payloads: list):
        import torch

        self.config, self.program, self.payloads = config, program, payloads
        self.streams = [program.compress_indexed(p, config) for p in payloads]
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        self._shapes = {}

    def one(self, i: int):
        stream, index = self.streams[i]
        answer = self.program.decompress_indexed(stream, index, self.config)
        return answer, len(self.payloads[i]), len(stream)

    def shape(self, i: int, answer) -> dict:
        if i not in self._shapes:
            stream, index = self.streams[i]
            lanes = [blocks.walk(lane, stop_at_eob=True)
                     for lane, _, _ in check._lanes(stream, index, self.payloads[i],
                                                     self.config.chunk_size)]
            self._shapes[i] = blocks.shape(lanes, len(self.payloads[i]), len(stream))
        return self._shapes[i]

    def judge(self, window, config: dict) -> dict:
        distinct = {}
        for p, answer in [*window.sample, *window.last.items()]:
            distinct.setdefault((p, hashlib.sha256(answer).hexdigest()), (p, answer))
        streams = check.Judge(config)
        for (stream, index), p in zip(self.streams, self.payloads):
            streams.stream(stream, index, p)
        return {"bytes_bad": (sum(answer != self.payloads[p]
                                  for p, answer in distinct.values()), 0),
                **streams.checks(),
                "ratio": (check.ratio(dict(enumerate(self.streams)), self.payloads),
                          config["limits"]["ratio"])}
