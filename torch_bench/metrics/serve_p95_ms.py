"""95th percentile of the latency of every request due in the window, from
its due time to its full response (a failed request's is infinite), ms."""

import numpy as np


def read(run):
    lat = run.counts["latency_ms"]
    return float(np.percentile(lat, 95, method="higher")) if len(lat) else None
