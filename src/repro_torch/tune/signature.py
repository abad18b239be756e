"""Problem signatures: the autotuner's cache key (port of
``repro.tune.signature``).

A tuned :class:`~repro_torch.core.engine.EngineConfig` transfers only
between problems that stress the engine the same way, which KPynq's
cost model says is (platform, N, K, D): the platform picks the backend,
N the capacity lattice, K the candidate pass's width, D the arithmetic
intensity of every distance. N is bucketed to its power-of-two ceiling,
the engine's own capacity lattice.

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


def _check_shards(shards: int) -> None:
    if int(shards) > 1:
        raise NotImplementedError(
            "sharded tuning keys (shards > 1) are not ported yet: ROADMAP "
            "Queue 1 item 9 (the sharded drivers)")


def signature(n: int, k: int, d: int, platform: str | None = None,
              shards: int = 1) -> str:
    """Cache key for a (platform, N, K, D) problem class. ``shards > 1``
    (the distributed engine's key) raises ``NotImplementedError``."""
    _check_shards(shards)
    if platform is None:
        platform = platform_name()
    return f"{PREFIX}|{platform}|n{pow2_bucket(n)}|k{int(k)}|d{int(d)}"
