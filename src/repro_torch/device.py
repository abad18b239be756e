"""Device resolution for the port's entry points.

Every entry point (``KMeans``, ``engine.fit``, ``engine.assign``)
takes ``device=None``, which means ``cuda``. A CUDA device that is not
there raises: the port never carries on quietly on the CPU. The CPU
runs only when the caller asks for it, as the parity tests do.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``. Raises ``RuntimeError`` when a CUDA device
    is asked for (or defaulted to) and ``torch.cuda.is_available()`` is
    false. On CUDA, fp32 matmuls are pinned to full fp32: TF32 keeps
    about three decimal digits, which changes labels."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: CUDA device requested (the default) but "
                "torch.cuda.is_available() is false; pass device='cpu' "
                "to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def as_float32(x, device: torch.device) -> torch.Tensor:
    """A float32 tensor on ``device`` from a tensor or anything numpy
    takes (numpy input is copied, never aliased)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=device)
