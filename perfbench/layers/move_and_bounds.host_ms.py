"""Host ms a fit inside the program's ``kpynq/move_and_bounds`` spans:
the host's issue time of the move and the bounds' upkeep, beside
``move_and_bounds.device_ms``."""
from perfbench import spans


def read(run):
    return spans.ms_per_call(run, "kpynq/move_and_bounds")
