"""Host pack of a scan: the program's t_prepare stage timer (the native
pack and the transfer's start) over the window's scans."""


def read(run):
    n = run.window.scans
    s = run.timer_s("t_prepare")
    return 1e3 * s / n if n and s > 0 else None
