"""LiDAR scans completed in the window over the window's whole time, the
final synchronize included; radar and odometry between scans are part of
the work."""


def read(run):
    w = run.window
    return w.scans / w.seconds if w.scans else None
