"""Median over all events of the window of the time from the hand-over
to the pose on the host."""

from benchmark.drive import percentile


def read(run):
    lat = run.window.latency_s
    return 1e3 * percentile(lat, 50) if lat else None
