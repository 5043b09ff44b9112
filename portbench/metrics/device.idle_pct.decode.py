"""The share of the traced decode window's wall time in which nothing ran
on the card (%): the window runs from the first traced call's start to
the last one's end, and the card is busy in the union of the profiler's
device intervals, copies included."""

from portbench.decode_spans import calls


def read(trace):
    if not calls(trace):
        return None
    return 100 * (1 - trace.busy_s / trace.window_s)
