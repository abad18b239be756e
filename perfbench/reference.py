"""The plain reference of the filtered k-means fit: Lloyd's iteration in
plain PyTorch, with none of the program's filters, kernels or tables.

Yinyang's filters are exact, so the fit the program runs,
``repro_torch.core.engine.fit(X, C0, max_iters=..., tol=...)``, is
Lloyd's iteration from C0 with the same exit:

    a_0 = nearest(X, C_0)
    for it = 1, 2, ...  while it <= max_iters and shift > tol:
        C_it = mean of X under a_(it-1)   (an empty cluster keeps its row)
        shift = max_k |C_it[k] - C_(it-1)[k]|
        a_it = nearest(X, C_it)

and it returns (C_n, a_n, n, sum |x - C_n[a_n]|^2), ``tol`` rounded to
float32 as the program compares it. Ties go to the lower index.

``precision`` "float64" is the reference. "tf32" is the control: the
same arithmetic in float32 with the distance products on TensorFloat-32
(on CUDA the library's TF32 path; elsewhere the operands rounded to
TF32's 10-bit mantissa, which is what the tensor cores do with them).
"float32" is full float32, for the tests. TF32 stays off otherwise: a
float32 product on the card runs in full float32 only while
``torch.backends.cuda.matmul.allow_tf32`` is False.

Imports nothing but torch; takes nothing that the program made.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

PRECISIONS = ("float64", "float32", "tf32")
BLOCK_ROWS = 1 << 16


class Fit(NamedTuple):
    centroids: torch.Tensor   # (K, D) in the fit's precision
    labels: torch.Tensor      # (N,) int64
    n_iters: int
    inertia: float


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to the nearest TF32 value (10 mantissa
    bits, ties away from zero, as the tensor cores convert)."""
    bits = t.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


@contextlib.contextmanager
def _matmul_mode(precision: str, device: torch.device):
    """TF32 on for the control on CUDA, off (and restored) otherwise."""
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    flags.allow_tf32 = precision == "tf32" and device.type == "cuda"
    try:
        yield
    finally:
        flags.allow_tf32 = before


def _dtype(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")
    return torch.float64 if precision == "float64" else torch.float32


def _product(xb, ct, precision: str):
    if precision == "tf32" and xb.device.type != "cuda":
        return tf32_round(xb) @ tf32_round(ct)
    return xb @ ct


def nearest(points, centroids, precision: str = "float64",
            block_rows: int = BLOCK_ROWS):
    """(labels (N,) int64, squared distances (N,)) of each point's
    nearest centroid, |x|^2 - 2 x.c + |c|^2 in ``precision``, in blocks
    of rows."""
    dt = _dtype(precision)
    c = centroids.to(dt)
    c2 = torch.sum(c * c, dim=1)
    ct = c.T.contiguous()
    labels, best = [], []
    with _matmul_mode(precision, points.device):
        for lo in range(0, points.shape[0], block_rows):
            xb = points[lo:lo + block_rows].to(dt)
            x2 = torch.sum(xb * xb, dim=1)
            d2 = x2[:, None] - 2.0 * _product(xb, ct, precision) + c2[None]
            val, idx = torch.min(d2, dim=1)
            labels.append(idx)
            best.append(val)
    return torch.cat(labels), torch.cat(best)


def centroid_means(points, labels, previous, precision: str = "float64",
                   block_rows: int = BLOCK_ROWS):
    """Each cluster's mean under ``labels``; an empty cluster keeps its
    row of ``previous``."""
    dt = _dtype(precision)
    k, d = previous.shape
    sums = torch.zeros((k, d), dtype=dt, device=points.device)
    for lo in range(0, points.shape[0], block_rows):
        sums.index_add_(0, labels[lo:lo + block_rows],
                        points[lo:lo + block_rows].to(dt))
    counts = torch.bincount(labels, minlength=k).to(dt)
    prev = previous.to(dt)
    return torch.where(counts[:, None] > 0,
                       sums / torch.clamp_min(counts, 1.0)[:, None], prev)


def inertia(points, centroids, labels, precision: str = "float64",
            block_rows: int = BLOCK_ROWS) -> float:
    """sum |x - c[label]|^2, taken directly, in ``precision``."""
    dt = _dtype(precision)
    c = centroids.to(dt)
    total = torch.zeros((), dtype=dt, device=points.device)
    for lo in range(0, points.shape[0], block_rows):
        diff = points[lo:lo + block_rows].to(dt) - c[labels[lo:lo +
                                                            block_rows]]
        total += torch.sum(diff * diff)
    return float(total)


def fit(points, init_centroids, *, max_iters: int, tol: float,
        precision: str = "float64", block_rows: int = BLOCK_ROWS) -> Fit:
    """Lloyd's fit from ``init_centroids`` with the program's exit (see
    the module's note)."""
    dt = _dtype(precision)
    tol32 = float(torch.tensor(tol, dtype=torch.float32))
    cent = init_centroids.to(dt)
    labels, _ = nearest(points, cent, precision, block_rows)
    it, shift = 0, float("inf")
    while it < max_iters and shift > tol32:
        new = centroid_means(points, labels, cent, precision, block_rows)
        shift = float(torch.max(torch.sqrt(torch.sum((new - cent) ** 2,
                                                     dim=1))))
        cent = new
        it += 1
        labels, _ = nearest(points, cent, precision, block_rows)
    return Fit(cent, labels, it,
               inertia(points, cent, labels, precision, block_rows))
