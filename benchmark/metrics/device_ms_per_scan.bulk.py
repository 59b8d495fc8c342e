"""Device busy time (the union of kernel and copy intervals) of the traced
chunk over the scan steps it ran, counted by their ICP launches
(n_gn_iters + 1 a scan step)."""


def scans(run):
    t = run.trace
    if t is None:
        return 0
    return t.kernels["icp_linearize_kernel"][0] / (run.n_gn_iters + 1)


def read(run):
    n = scans(run)
    return 1e3 * run.trace.busy_s / n if n else None
