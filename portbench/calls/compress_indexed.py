"""``compress_indexed(payload, config)``: each call compresses one whole
payload into a zlib stream and its index of compressed chunk sizes, and
ends with both on the host, as users call it.  The answers are judged by
``check.judge_streams``."""

from portbench import check

SPAN = "api.compress"
KIND = "encode"


class Call:
    def __init__(self, mix: dict, config, program, payloads: list):
        self.config, self.program, self.payloads = config, program, payloads

    def one(self, i: int):
        answer = self.program.compress_indexed(self.payloads[i], self.config)
        return answer, len(self.payloads[i]), len(answer[0])

    def shape(self, i: int, answer) -> dict:
        cfg = self.config
        return {"lanes": len(answer[1]), "chunk": cfg.chunk_size, "raw_bytes": len(self.payloads[i]),
                "window": cfg.window, "max_match": cfg.max_match,
                "dynamic_encode": cfg.dynamic_encode,
                "lane_bytes": [int(x) for x in answer[1]]}

    def judge(self, window, config: dict) -> dict:
        return check.judge_streams(window, self.payloads, config)
