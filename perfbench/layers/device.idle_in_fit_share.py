"""The share of the traced fits' own time in which no operation ran on
the card, in %: 1 - the union of the device operations clipped to the
program's ``kpynq/fit`` spans over those spans' length. Unlike
``device.idle_share`` it leaves out the benchmark driver's work between
fits."""
from perfbench import spans


def read(run):
    tr = run.trace
    if tr is None or not tr.ops:
        return None
    fits = spans.union(spans.clipped(tr, "kpynq/fit"))
    length = sum(e - s for s, e in fits)
    if length <= 0:
        return None
    busy = sum(max(0.0, min(e, fe) - max(s, fs))
               for s, e in tr.intervals() for fs, fe in fits)
    return 100.0 * (1.0 - busy / length)
