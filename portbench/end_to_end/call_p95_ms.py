"""The 95th percentile of every call's latency in the window, in ms: from
the start of the call (its update, where it has one) to its output being
ready on the card."""

import statistics


def read(w) -> float:
    return statistics.quantiles(w.latencies_s, n=20, method="inclusive")[18] * 1e3
