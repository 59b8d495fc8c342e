"""Host time from the hand-over to the return of the add_* call, before
the read-back, averaged over all events of the window."""


def read(run):
    s = run.window.submit_s
    return 1e3 * sum(s) / len(s) if s else None
