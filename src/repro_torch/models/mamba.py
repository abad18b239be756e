"""Mamba-2 (SSD, state-space duality) block, chunked form (port of
``repro.models.mamba``).

Per head h with state size N and head dim P:
    s_t = exp(dt_t * A_h) * s_{t-1} + dt_t * B_t x_t^T        (N x P state)
    y_t = C_t s_t + D_h x_t
The chunked algorithm splits the sequence into chunks of Q tokens: an
intra-chunk quadratic term, which is the ``ssd_intra`` kernel
(``kernels.ssd_intra_chunks``, one cell per batch, chunk and head), and
an inter-chunk recurrence over tiny (H, N, P) states. The reference
runs that recurrence as an ``associative_scan``; here it is a loop over
chunks, the same sums in sequence. Decode keeps the (H, N, P) state
and a conv ring buffer: O(1) per token.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels
from ..kernels.ssd_intra import repeat_groups
from .layers import rms_norm


def _causal_conv(xbc, conv_w, conv_cache=None):
    """Depthwise causal conv1d, window W. xbc: (B, S, C); conv_w: (W, C).
    With conv_cache (B, W-1, C) prepends history (decode path).
    Returns (silu(conv), the last W-1 inputs)."""
    w = conv_w.shape[0]
    if conv_cache is None:
        pad = xbc.new_zeros((xbc.shape[0], w - 1, xbc.shape[2]))
    else:
        pad = conv_cache.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)                     # (B, S+W-1, C)
    s = xbc.shape[1]
    out = full[:, 0:s] * conv_w[0].to(xbc.dtype)
    for i in range(1, w):
        out = out + full[:, i:i + s] * conv_w[i].to(xbc.dtype)
    new_cache = full[:, -(w - 1):] if w > 1 else pad
    return F.silu(out), new_cache


def ssd_chunked(x, dt, A, B, C, D, *, chunk: int,
                return_state: bool = False):
    """x: (B,S,H,P); dt: (B,S,H); A: (H,) < 0; B, C: (B,S,G,N); D: (H,).
    G (state groups) broadcasts over heads. Returns y: (B,S,H,P) in x's
    dtype (and the final recurrent state (B,H,N,P) fp32 when
    ``return_state``)."""
    b, s_orig, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q = min(chunk, s_orig)
    # pad S to a chunk multiple: dt = 0 padding is exact (decay exp(0) =
    # 1, zero discretised input: padded steps leave the state as it is)
    pad = (-s_orig) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    s = s_orig + pad
    nc = s // q
    rep = h // g

    xf = (x * dt[..., None]).float()                        # discretised input
    la = dt.float() * A[None, None, :]                      # log-decay per token
    xc = xf.reshape(b, nc, q, h, p)
    lac = la.reshape(b, nc, q, h)
    Bc = B.reshape(b, nc, q, g, n).float()
    Cc = C.reshape(b, nc, q, g, n).float()
    cum = torch.cumsum(lac, dim=2)                          # (B,NC,Q,H)
    total = cum[:, :, -1]                                   # (B,NC,H)

    # intra-chunk quadratic term: ((C B^T) ∘ tril(exp(cum_i - cum_j))) x
    y_intra = kernels.ssd_intra_chunks(Cc, Bc, xc, cum)     # (B,NC,Q,H,P)

    # chunk state contribution: sum_j exp(total - cum_j) B_j x_j
    w_in = torch.exp(total[:, :, None, :] - cum)            # (B,NC,Q,H)
    Bh = repeat_groups(Bc, rep, dim=3)                      # (B,NC,Q,H,N)
    state_in = torch.einsum("bcjhn,bcjhp->bchnp", Bh * w_in[..., None], xc)
    # inter-chunk recurrence: state_c = state_{c-1} exp(total_c) + in_c
    decay = torch.exp(total)[..., None, None]               # (B,NC,H,1,1)
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * decay[:, c] + state_in[:, c]
    prev_states = torch.stack(prev, dim=1)                  # (B,NC,H,N,P)

    Ch = repeat_groups(Cc, rep, dim=3)                      # (B,NC,Q,H,N)
    y_inter = torch.einsum("bcihn,bchnp->bcihp", Ch, prev_states) * \
        torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(b, s, h, p)
    y = (y + x.float() * D[None, None, :, None]).to(x.dtype)
    y = y[:, :s_orig]
    if return_state:
        return y, state
    return y


def ssd_decode_step(x, dt, A, B, C, D, state):
    """Single-token recurrence. x: (B,H,P); dt: (B,H); B, C: (B,G,N);
    state: (B,H,N,P) fp32. Returns (y (B,H,P), new_state)."""
    h, g = x.shape[1], B.shape[1]
    rep = h // g
    da = torch.exp(dt.float() * A[None, :])                 # (B,H)
    Bh = B.float().repeat_interleave(rep, dim=1)            # (B,H,N)
    Ch = C.float().repeat_interleave(rep, dim=1)
    xf = (x * dt[..., None]).float()
    new_state = state * da[:, :, None, None] + Bh[..., :, None] * xf[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", Ch, new_state)
    return (y + x.float() * D[None, :, None]).to(x.dtype), new_state


def _project(x, p, cfg, conv_cache=None):
    """in_proj, dt_proj and the causal conv shared by prefill and
    decode: (z, xs, Bm, Cm, dt, conv_cache) with Bm, Cm (B, S, G, N)."""
    b, s, _ = x.shape
    m = cfg.ssm
    di, gn = m.d_inner, m.n_groups * m.d_state
    proj = x @ p["in_proj"].to(x.dtype)
    z = proj[..., :di]
    dt = x @ p["dt_proj"].to(x.dtype)
    xbc, conv_cache = _causal_conv(proj[..., di:], p["conv_w"], conv_cache)
    xs = xbc[..., :di]
    Bm = xbc[..., di:di + gn].reshape(b, s, m.n_groups, m.d_state)
    Cm = xbc[..., di + gn:].reshape(b, s, m.n_groups, m.d_state)
    dt = F.softplus(dt.float() + p["dt_bias"].float())      # (B,S,H)
    return z, xs, Bm, Cm, dt, conv_cache


def mamba_mixer_train(x, p, cfg, return_state: bool = False):
    """Full Mamba-2 mixer. x: (B, S, D) -> (B, S, D).
    ``return_state=True`` also returns (ssm_state, conv_cache): the
    prefill cache."""
    b, s, _ = x.shape
    m = cfg.ssm
    z, xs, Bm, Cm, dt, conv_cache = _project(x, p, cfg)
    A = -torch.exp(p["A_log"].float())                      # (H,)
    xh = xs.reshape(b, s, m.n_heads, m.head_dim)
    y = ssd_chunked(xh, dt, A, Bm, Cm, p["D"].float(), chunk=m.chunk,
                    return_state=return_state)
    if return_state:
        y, final_state = y
    y = rms_norm(y.reshape(b, s, m.d_inner) * F.silu(z), p["out_norm"])
    out = y @ p["out_proj"].to(x.dtype)
    if return_state:
        return out, final_state, conv_cache
    return out


def mamba_mixer_decode(x, p, cfg, ssm_state, conv_cache):
    """x: (B, 1, D); ssm_state: (B,H,N,P) fp32; conv_cache: (B,W-1,C).
    Returns (out (B, 1, D), new ssm_state, new conv_cache)."""
    b = x.shape[0]
    m = cfg.ssm
    z, xs, Bm, Cm, dt, conv_cache = _project(x, p, cfg, conv_cache)
    A = -torch.exp(p["A_log"].float())
    xh = xs[:, 0].reshape(b, m.n_heads, m.head_dim)
    y, ssm_state = ssd_decode_step(xh, dt[:, 0], A, Bm[:, 0], Cm[:, 0],
                                   p["D"].float(), ssm_state)
    y = rms_norm(y.reshape(b, 1, m.d_inner) * F.silu(z), p["out_norm"])
    return y @ p["out_proj"].to(x.dtype), ssm_state, conv_cache
