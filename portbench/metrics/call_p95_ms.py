"""The 95th percentile, over the calls of the window, of a call's latency:
from its issue by the host to its completion, both marked on the device's
clock (`harness.closed_loop`). With calls in flight it holds the wait
behind the calls issued before, so a stall of the device or of the call's
own wait shows here where a rate averages it away."""

import math


def read(run):
    lat = sorted(run.get("latencies_ms") or ())
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1]
