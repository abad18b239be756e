"""Host ms a fit inside the program's ``kpynq/candidate_pass`` spans
(the loop's passes and the epilogue's): the host's issue time of the
pass, beside ``candidate_pass.device_ms``, the device time it
launched."""
from perfbench import spans


def read(run):
    return spans.ms_per_call(run, "kpynq/candidate_pass")
