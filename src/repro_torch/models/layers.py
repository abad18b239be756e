"""Shared transformer building blocks (port of ``repro.models.layers``):
activations in the compute dtype, norms and rotations in fp32."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, Dh) rotated pairwise (halves); positions: (..., S)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                 # (Dh/2,)
    angles = positions[..., :, None].float() * freqs        # (..., S, Dh/2)
    cos = torch.cos(angles)[..., :, None, :]                # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    g = x @ w_gate.to(x.dtype)
    u = x @ w_up.to(x.dtype)
    return (F.silu(g) * u) @ w_down.to(x.dtype)
