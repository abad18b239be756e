"""One module a kernel: the bytes a launch of it needs, from the cell's
shapes alone, the operations its traced launches needed, where the
kernel does arithmetic worth counting, and how its launches are found
in the trace.

Each module names ``KERNELS`` (a regular expression over the device
kernels one launch runs), ``LAUNCH`` (the one kernel that marks each
launch), ``RANGE`` (the program's profiler range whose launches are
counted) and ``launch_bytes(config)``; it may name
``traced_flops(reading)``, the operations of all the traced launches
together, from what the traced fits report. Each byte a launch reads or
writes is counted once, whatever the kernel reads again; the counts
read the same whatever implements the kernel.
"""
from __future__ import annotations

import importlib
import re


def least_s(reading, kernel: str, launches: int) -> tuple[float, str]:
    """The least time of the traced launches and what bounds it: the
    larger of their bytes at the card's HBM rate and their operations
    at its fp32 rate (``"bytes"`` or ``"operations"``)."""
    mod = importlib.import_module(f"{__name__}.{kernel}")
    by_bytes = launches * mod.launch_bytes(reading.config) \
        / reading.peaks["hbm_bytes_per_s"]
    flops = getattr(mod, "traced_flops", None)
    by_ops = 0.0 if flops is None else \
        flops(reading) / reading.peaks["fp32_flops_per_s"]
    return (by_ops, "operations") if by_ops > by_bytes \
        else (by_bytes, "bytes")


def share(reading, kernel: str) -> float | None:
    """The kernel's share of its roofline over the traced launches, in
    %: their least time (:func:`least_s`) over the device time of the
    kernels they ran. None where the trace holds no launch or the card
    has no row of peaks. Over 100% a count is wrong (or the time leaves
    out work): that raises, and the run fails."""
    mod = importlib.import_module(f"{__name__}.{kernel}")
    if reading.trace is None or reading.peaks is None:
        return None
    ops = reading.trace.launched_in(mod.RANGE, mod.KERNELS)
    launches = sum(1 for o in ops if re.search(mod.LAUNCH, o.name))
    seconds = sum(o.end - o.start for o in ops) / 1e6
    if not launches or seconds <= 0:
        return None
    least, _ = least_s(reading, kernel, launches)
    pct = 100.0 * least / seconds
    if pct > 100.0:
        raise RuntimeError(f"{kernel}_roofline reads {pct}%: the count of "
                           f"bytes or operations, or the kernels' time, is "
                           f"wrong")
    return pct
