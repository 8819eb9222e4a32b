"""95th percentile (nearest rank) of the latencies of the requests the
traced run times one by one, each from its call to its host results, in
ms."""
import math


def read(t):
    lat = sorted(t.get("request_latency_s") or ())
    if not lat:
        return None
    return 1e3 * lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
