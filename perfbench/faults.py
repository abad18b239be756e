"""Faults planted in the program underneath a run, to show that the
comparison catches them (``test_perfbench_faults.py``, and on the card
``calibrate.py --faults``). Each is a context manager that swaps one
function of ``repro_torch.core.engine`` for the length of the block:

``unchanged``
    the move returns its state unchanged: the centroids it was given,
    no drift.
``half_batch``
    the centroid sums leave out the second half of the points: each
    mean is taken over the rest.
``altered``
    the last candidate pass alters one label where it produces it.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _swapped(name: str, make):
    from repro_torch.core import engine
    original = getattr(engine, name)
    setattr(engine, name, make(original))
    try:
        yield
    finally:
        setattr(engine, name, original)


def unchanged():
    def make(move):
        def stuck(points, centroids, *args, **kw):
            out = move(points, centroids, *args, **kw)
            return out._replace(
                centroids=centroids,
                c2=torch.sum(centroids * centroids, dim=-1),
                shift=torch.zeros_like(out.shift),
                drift=torch.zeros_like(out.drift),
                gdrift=torch.zeros_like(out.gdrift))
        return stuck
    return _swapped("move_and_bounds", make)


def half_batch():
    def make(sums):
        def half(points, assignments, k, weights=None):
            keep = points.shape[0] // 2
            return sums(points[:keep], assignments[:keep], k,
                        weights=None if weights is None else weights[:keep])
        return half
    return _swapped("centroid_sums", make)


def altered():
    def make(epilogue):
        def alter(core, points, *args, **kw):
            labels, evals, inertia = epilogue(core, points, *args, **kw)
            labels = labels.clone()
            labels[0] = (labels[0] + 1) % core.k
            return labels, evals, inertia
        return alter
    return _swapped("_epilogue_pass", make)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered}
