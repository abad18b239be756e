"""Host us of one kernel launch through its wrapper: the mean length of
the program's ``kpynq/grouped_assign`` and ``kpynq/centroid_update``
spans (checks, allocations, the entry's lookup and the ``ctypes``
launch), clipped to the window. None without a device operation in the
trace (a CPU rehearsal takes the plain versions)."""
from perfbench import spans


def read(run):
    tr = run.trace
    if tr is None or not tr.ops:
        return None
    found = spans.clipped(tr, "kpynq/grouped_assign",
                          "kpynq/centroid_update")
    if not found:
        return None
    return sum(e - s for s, e in found) / len(found)
