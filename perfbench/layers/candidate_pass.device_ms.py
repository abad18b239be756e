"""Device ms a fit of the operations launched inside the program's
``kpynq/candidate_pass`` ranges (the loop's passes and the epilogue's),
from the trace of the traced fits."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    ops = tr.launched_in("kpynq/candidate_pass")
    if not ops:
        return None
    return sum(o.end - o.start for o in ops) / 1e3 / tr.calls
