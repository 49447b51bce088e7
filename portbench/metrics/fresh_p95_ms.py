"""fresh_p95_ms (ms, host clock): for every event due in the window, the
time from its due time to the end of the first recount that includes it;
the 95th percentile (nearest rank) over all of them.  An event that
failed or was never answered counts as missing every limit; where the
missing reach the percentile there is no number."""

import math


def read(run):
    lat = sorted(
        math.inf if e["failed"] or e["answered"] is None else e["answered"] - e["due"]
        for e in run.events
    )
    if not lat:
        return None
    p95 = lat[math.ceil(0.95 * len(lat)) - 1]
    return None if math.isinf(p95) else 1e3 * p95
