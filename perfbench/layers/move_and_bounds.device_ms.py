"""Device ms a fit of the operations launched inside the program's
``kpynq/move_and_bounds`` ranges (the centroid sums, the drift and the
bounds' upkeep), from the trace of the traced fits."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    ops = tr.launched_in("kpynq/move_and_bounds")
    if not ops:
        return None
    return sum(o.end - o.start for o in ops) / 1e3 / tr.calls
