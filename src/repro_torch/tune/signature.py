"""Problem signatures: the autotuner's cache key (port of
``repro.tune.signature``).

A tuned :class:`~repro_torch.core.engine.EngineConfig` transfers only
between problems that stress the engine the same way, which KPynq's
cost model says is (platform, N, K, D): the platform picks the backend,
N the capacity lattice, K the candidate pass's width, D the arithmetic
intensity of every distance. N is bucketed to its power-of-two ceiling,
the engine's own capacity lattice.

The sharded engine adds a shard count (``shards=``): a capacity ladder
tuned for one shard of an S-way fit pays an all-reduce an iteration and
is not interchangeable with the single-device entry for the same
per-shard N, so sharded winners are keyed apart as ``...|sS``, with
``n`` the per-shard count. ``shards=1`` keeps the plain key.

The platform part is the card's name from
``torch.cuda.get_device_name`` with spaces replaced by ``_`` (an H100 80GB
HBM3 and an H100 PCIe tune apart), or ``cpu``. Every key of the port
starts with ``torch|``, a field no key of the JAX package has, so a key
the JAX package wrote can never match one of the port's, even in one
file.
"""
from __future__ import annotations

PREFIX = "torch"


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << (max(int(n), 1) - 1).bit_length()


def platform_name(device=None) -> str:
    """The platform part of a key for ``device``: the CUDA card's name,
    spaces replaced, or ``cpu``. ``None`` means ``cuda`` where a card is
    there (the entry points' default), else ``cpu``."""
    import torch
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    return torch.cuda.get_device_name(device).strip().replace(" ", "_")


def signature(n: int, k: int, d: int, platform: str | None = None,
              shards: int = 1) -> str:
    """Cache key for a (platform, N, K, D[, shards]) problem class.
    ``n`` is the PER-SHARD point count when ``shards > 1``."""
    if platform is None:
        platform = platform_name()
    sig = f"{PREFIX}|{platform}|n{pow2_bucket(n)}|k{int(k)}|d{int(d)}"
    if int(shards) > 1:
        sig += f"|s{int(shards)}"
    return sig
