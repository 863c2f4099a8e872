"""95th percentile (nearest rank) of every request of the window, each
timed from its submit to its response."""

import math


def read(rec):
    lat = sorted(rec.get("latencies_ms") or ())
    return lat[math.ceil(0.95 * len(lat)) - 1] if lat else None
