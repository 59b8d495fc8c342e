"""Host time of the bulk scheduler a scan: the program's stage timers
t_bulk_pack + t_bulk_put + t_bulk_dispatch over the window, over its
scans."""

STAGES = ("t_bulk_pack", "t_bulk_put", "t_bulk_dispatch")


def read(run):
    s = sum(run.timer_s(k) for k in STAGES)
    n = run.window.scans
    return 1e3 * s / n if n and s > 0 else None
