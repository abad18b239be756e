"""``grouped_assign``'s share of its roofline, in % (see
``perfbench/rooflines/grouped_assign.py`` for its bytes and operations)."""
from perfbench import rooflines


def read(run):
    return rooflines.share(run, "grouped_assign")
