"""95th percentile over all events of the window of the time from the
hand-over to the pose on the host (all samples, not chunk medians)."""

from benchmark.drive import percentile


def read(run):
    lat = run.window.latency_s
    return 1e3 * percentile(lat, 95) if lat else None
