"""The ICP kernel's share of its roofline over the traced stretch: the
least time the card could take for its launches (bytes or operations from
the shapes, ``cost.py``, against the published peaks of the card) over the
time the profiler gives the kernel. Operations are counted with every lane
an inlier, the most the inputs can need; bytes bound it all the same."""

from benchmark import cost


def read(run):
    t = run.trace
    peak = cost.peaks(run.device_kind)
    if t is None or peak is None:
        return None
    launches, secs = t.kernels["icp_linearize_kernel"]
    if not launches or secs <= 0:
        return None
    n = run.n_icp_points
    share, _ = cost.roofline(launches * cost.icp_bytes(n),
                             launches * cost.icp_flops(n, n), secs, peak)
    return share
