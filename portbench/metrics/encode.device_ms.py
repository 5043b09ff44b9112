"""The card's time a compress call in kernels, memsets and device-to-device
copies, from the profiler (ms); host<->device copies are the API's."""

from portbench.trace import mean

SPAN = "api.compress"


def read(trace):
    return mean([c.device_ms for c in trace.of(SPAN)])
