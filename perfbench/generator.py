"""Inputs made from seeds: the points of a cell, its restarts' initial
centroids and the order of both in a run.

The points follow the Gaussian-blob recipe of ``repro_torch.data.
make_points``, rewritten in torch so that they are made on the card in a
few large calls: ``n_centres`` centres with coordinates ~ N(0,
spread^2), each point's centre drawn uniformly, noise ~ N(0,
cluster_std^2). A restart's initial centroids are K distinct rows of
the points, drawn from (seed, restart); :func:`rotation` turns the
points into a frame of their own for one run, :func:`permutation`
orders them and :func:`order` orders a pool of restarts. Every stream
has a ``torch.Generator`` of its own, seeded from a hash of (seed,
stream, index), so any whole seed (also past 64 bits) gives the same
inputs on every run, and a restart's draw does not depend on how many
restarts came before it.
"""
from __future__ import annotations

import hashlib

import torch


def derive(seed: int, stream: str, index: int = 0) -> int:
    """A 63-bit generator seed for one stream of a run."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}:{int(index)}".encode())
    return int.from_bytes(digest.digest()[:8], "little") >> 1


def generator(device, seed: int, stream: str, index: int = 0):
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, stream, index))
    return g


def make_points(n: int, d: int, *, n_centres: int, spread: float,
                cluster_std: float, seed: int, device) -> torch.Tensor:
    """(n, d) float32 points on ``device``."""
    g = generator(device, seed, "points")
    centres = torch.randn((n_centres, d), generator=g, device=device,
                          dtype=torch.float32) * spread
    which = torch.randint(0, n_centres, (n,), generator=g, device=device)
    noise = torch.randn((n, d), generator=g, device=device,
                        dtype=torch.float32)
    return torch.addcmul(centres[which], noise,
                         torch.tensor(cluster_std, device=device))


def initial_rows(n: int, k: int, *, seed: int, restart: int, device,
                 stream: str = "restart") -> torch.Tensor:
    """K distinct row indices of an (n, d) point set for one restart
    (``stream`` "warmup" for the fits before the window)."""
    g = generator(device, seed, stream, restart)
    return torch.randperm(n, generator=g, device=device)[:k]


def rotation(d: int, *, seed: int) -> torch.Tensor:
    """A (d, d) float64 orthogonal matrix on the host, uniform over the
    orthogonal group (the QR of a Gaussian matrix, signs fixed by R's
    diagonal). Points times it keep every distance and norm, so a fit
    does the same work; every coordinate is another number."""
    g = torch.Generator()
    g.manual_seed(derive(seed, "rotation"))
    q, r = torch.linalg.qr(torch.randn((d, d), generator=g,
                                       dtype=torch.float64))
    return q * torch.sign(torch.diagonal(r))[None, :]


def rotate(points: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``points @ q`` worked out in float64 and rounded once to float32."""
    return (points.double() @ q.to(points.device)).float()


def permutation(n: int, *, seed: int, device) -> torch.Tensor:
    """The order of the points for one run."""
    return torch.randperm(n, generator=generator(device, seed, "order"),
                          device=device)


def order(p: int, *, seed: int, cycle: int) -> list[int]:
    """The order of a pool of ``p`` restarts in one cycle of a run."""
    g = torch.Generator()
    g.manual_seed(derive(seed, "cycle", cycle))
    return torch.randperm(p, generator=g).tolist()
