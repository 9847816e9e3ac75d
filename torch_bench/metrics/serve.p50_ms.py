"""The median latency of every request due in the traced window, from its
due time to its full response (a failed request's is infinite), ms: a
steadier statistic beside the tail, without a bound (its runs spread by
11-15 % between processes)."""

import numpy as np


def read(run):
    lat = run.counts["latency_ms"]
    return float(np.percentile(lat, 50, method="higher")) if len(lat) else None
