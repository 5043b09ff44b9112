"""The card's time a decode call in kernels, memsets and device-to-device
copies, from the profiler (ms); host<->device copies are the API's."""

from portbench.decode_spans import calls
from portbench.trace import mean


def read(trace):
    return mean([c.device_ms for c in calls(trace)])
