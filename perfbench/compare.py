"""The comparison that decides ``correct`` for a fit: the program's
answer set beside the plain reference's, number by number.

Each number is the worst over the fits it is taken on:

``label_gap``
    Of every fit in the window, by its own centroids: the most by which
    a point's label lies farther than its nearest centroid,
    (|x - c_label|^2 - |x - c_nearest|^2) / (|x|^2 + |c_nearest|^2), in
    float64. A label out of range reads inf. It judges the last
    candidate pass, whatever came before it.
``move_gap``
    Of every fit in the window, by its own labels: the median over the
    clusters of |mean of the cluster's points - its centroid|, over the
    root mean square distance of a point to its centroid, in float64.
    Lloyd's next move would take each centroid to that mean, so a sound
    fit reads the size of its next step; a move that sums the wrong
    points, or returns its centroids unchanged, reads far more. The
    median leaves out the few centroids that still wander between two
    blobs.
``labels_off_ref``
    Of a sample of the fits drawn from the seed, against the reference's
    fit from the same initial centroids: the share of points whose labels
    differ. It judges the whole trajectory: every move and every pass.
``inertia_gap``
    Of the same sample: |inertia - the reference's| / the reference's.
``n_iters_gap``
    Of the same sample: |n_iters - the reference's|, the loop's exit.

A cell compares the numbers that ``limits/<cell>.json`` names (PERF.md
gives the readings each limit was set from); ``calibrate.py`` reads them
all. A number passes while it is at most its limit; NaN fails.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import reference

NUMBERS = ("label_gap", "move_gap", "labels_off_ref", "inertia_gap",
           "n_iters_gap")
PER_FIT = ("label_gap", "move_gap")


class Answer(NamedTuple):
    """What one fit returned, on the host."""
    centroids: torch.Tensor   # (K, D)
    labels: torch.Tensor      # (N,)
    n_iters: int
    inertia: float


def label_gap(points, centroids, labels,
              block_rows: int = reference.BLOCK_ROWS) -> float:
    """See the module's note. ``points`` on the device the work runs on;
    ``centroids`` and ``labels`` are moved there."""
    dev = points.device
    c = centroids.to(dev, torch.float64)
    lab = labels.to(dev, torch.int64)
    k = c.shape[0]
    if lab.shape != (points.shape[0],) or bool(((lab < 0) | (lab >= k))
                                                .any()):
        return float("inf")
    c2 = torch.sum(c * c, dim=1)
    worst = torch.zeros((), dtype=torch.float64, device=dev)
    for lo in range(0, points.shape[0], block_rows):
        xb = points[lo:lo + block_rows].to(torch.float64)
        x2 = torch.sum(xb * xb, dim=1)
        d2 = x2[:, None] - 2.0 * (xb @ c.T) + c2[None]
        best, at = torch.min(d2, dim=1)
        own = torch.gather(d2, 1, lab[lo:lo + block_rows, None])[:, 0]
        excess = own - best
        gap = torch.where(excess > 0, excess / (x2 + c2[at]), 0.0)
        worst = torch.maximum(worst, torch.max(gap))
    return float(worst)


def move_gap(points, centroids, labels) -> float:
    """See the module's note."""
    dev = points.device
    c = centroids.to(dev, torch.float64)
    lab = labels.to(dev, torch.int64)
    k = c.shape[0]
    if lab.shape != (points.shape[0],) or bool(((lab < 0) | (lab >= k))
                                                .any()):
        return float("inf")
    means = reference.centroid_means(points, lab, c)
    live = torch.bincount(lab, minlength=k) > 0
    rms = (reference.inertia(points, c, lab) / points.shape[0]) ** 0.5
    step = torch.linalg.norm(means - c, dim=1)[live]
    return float(torch.median(step)) / rms if rms > 0 else float("inf")


def against(ref: reference.Fit, answer: Answer) -> dict[str, float]:
    """``labels_off_ref``, ``inertia_gap`` and ``n_iters_gap`` of one
    fit beside the reference's fit from the same initial centroids."""
    lab = answer.labels.to(ref.labels.device, torch.int64)
    off = float((lab != ref.labels).sum()) / ref.labels.shape[0]
    return {"labels_off_ref": off,
            "inertia_gap": abs(answer.inertia - ref.inertia) / ref.inertia,
            "n_iters_gap": float(abs(answer.n_iters - ref.n_iters))}


def readings(points, answer: Answer, ref: reference.Fit | None = None,
             names=NUMBERS) -> dict[str, float]:
    """The numbers ``names`` of one fit; those against the reference
    need ``ref``, its fit from the same initial centroids."""
    out = {}
    if "label_gap" in names:
        out["label_gap"] = label_gap(points, answer.centroids, answer.labels)
    if "move_gap" in names:
        out["move_gap"] = move_gap(points, answer.centroids, answer.labels)
    if ref is not None:
        out.update({k: v for k, v in against(ref, answer).items()
                    if k in names})
    return out


def passes(value: float, limit: float) -> bool:
    return value <= limit


def check_lines(checks: dict[str, tuple[float, float]]) -> list[str]:
    """One line a number: its name, its reading and its limit."""
    return [f"check {name}: {value!r} limit {limit!r} "
            f"{'ok' if passes(value, limit) else 'FAILED'}"
            for name, (value, limit) in checks.items()]
