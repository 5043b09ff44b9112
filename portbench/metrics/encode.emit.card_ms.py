"""The stream's stretch between the CUDA events at the ends of the
program's ``td.encode.emit`` span, a compress call, averaged over the
traced calls (ms): the card's timeline from the stage's first work to its
last, launch gaps included."""

from portbench import spans

SPAN = "api.compress"


def read(trace):
    return spans.per_call(trace, SPAN, spans.card_ms("td.encode.emit"))
