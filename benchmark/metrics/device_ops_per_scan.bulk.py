"""Device ops (kernels and copies) of the traced chunk over the scan
steps it ran, counted by their ICP launches (n_gn_iters + 1 a step)."""


def read(run):
    t = run.trace
    if t is None:
        return None
    n = t.kernels["icp_linearize_kernel"][0] / (run.n_gn_iters + 1)
    return t.n_ops / n if n else None
