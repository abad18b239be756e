"""``centroid_update``'s share of its roofline, in % (see
``perfbench/rooflines/centroid_update.py`` for the bytes)."""
from perfbench import rooflines


def read(run):
    return rooflines.share(run, "centroid_update")
