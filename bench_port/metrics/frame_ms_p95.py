"""The 95th percentile (nearest rank) of every frame's latency in the
window, in milliseconds: the call that takes the frame in until it returns
with the frame's bytes on the host."""
import math


def read(run, part=None):
    lat = sorted(run.latencies)
    if not lat:
        return None
    return 1e3 * lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
