"""Device time of a scan event: the device ops that started inside the
benchmark's spans around scan events (hand-over to pose on the host, which
synchronizes), over those spans, in the traced stretch."""


def read(run):
    t = run.trace
    if t is None:
        return None
    secs, _, n = t.span_device("scan")
    return 1e3 * secs / n if n else None
