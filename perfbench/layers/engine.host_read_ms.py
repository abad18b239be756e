"""Host ms a fit blocked in the program's ``kpynq/host_read`` spans:
each host read of a device value that ``EngineStats.host_syncs`` counts
(the group table, the loop's exit scalars), from the group table's copy
to the value on the host. The card's lead over the host shows here."""
from perfbench import spans


def read(run):
    return spans.ms_per_call(run, "kpynq/host_read")
