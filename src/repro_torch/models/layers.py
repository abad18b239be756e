"""Shared transformer building blocks (port of ``repro.models.layers``):
activations in the compute dtype, norms, rotations and the loss in
fp32."""
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


def cross_entropy_chunked(hidden, lm_head, labels, *, chunk: int = 1024,
                          mask=None):
    """Mean softmax cross-entropy over the unmasked tokens, taken in
    chunks of the sequence so that fp32 logits never exist at
    (B, S, V): hidden (B, S, D), lm_head (D, V), labels (B, S) int. The
    reference's chunking (``n = max(S // chunk, 1)`` chunks of
    ``S // n``) and arithmetic: logits in the hidden dtype widened to
    fp32, ``logsumexp - gold`` per token, sums of the loss and the mask
    carried from chunk to chunk."""
    b, s, d = hidden.shape
    n_chunks = max(s // chunk, 1)
    chunk = s // n_chunks
    h = hidden.reshape(b, n_chunks, chunk, d).transpose(0, 1)
    y = labels.reshape(b, n_chunks, chunk).transpose(0, 1).long()
    if mask is None:
        m = torch.ones((n_chunks, b, chunk), dtype=torch.float32,
                       device=hidden.device)
    else:
        m = mask.reshape(b, n_chunks, chunk).transpose(0, 1).float()
    w = lm_head.to(hidden.dtype)
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    n_tok = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n_chunks):
        logits = (h[i] @ w).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, y[i][..., None])[..., 0]
        loss_sum = loss_sum + torch.sum((logz - gold) * m[i])
        n_tok = n_tok + torch.sum(m[i])
    return loss_sum / torch.clamp(n_tok, min=1.0)
