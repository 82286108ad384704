"""95th percentile of the batch latency over every batch the window
finished: from the pull of its cameras to its labels reaching the loop."""
import statistics


def read(rec):
    lat = rec["batch_latencies_s"]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18] * 1e3
