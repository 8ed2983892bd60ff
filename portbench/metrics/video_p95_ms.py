"""The 95th percentile, in ms, over every video of the window of the time
from the hand-off of its batch to the entry to its score on the host
(host clock; ``statistics.quantiles`` with n=20, 'exclusive')."""

import statistics


def read(r):
    lat = r.window["latency_s"]
    if len(lat) < 2:
        return None
    return 1e3 * statistics.quantiles(lat, n=20)[-1]
