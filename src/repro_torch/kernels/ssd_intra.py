"""Fused SSD intra-chunk pass (Mamba-2): the CUDA kernel, its plain
version and a launch counter.

Replaces the Pallas kernel ``repro/kernels/ssd_intra.py``
(``ssd_intra`` -> ``_ssd_intra_kernel``). Two wrappers launch the one
kernel (``csrc/ssd_intra.cu``, which holds the note on its design and
its bound) and count on ``ssd_intra.launches``:

- :func:`ssd_intra`, the reference's entry point: one (Q, N), (Q, P)
  cell per leading index;
- :func:`ssd_intra_chunks`, the model's launch: ``ssd_chunked``'s
  chunked tensors as they are, one cell per (batch, chunk, head), with
  B and C read from the group of each head (no repeated copy).

Inputs are float32 on the card (the model's are); a CPU tensor takes
the plain version, which also widens other types.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import ssd_intra_ref

NAME = "ssd_intra"
MAX_N = 128
MAX_P = 128


def ssd_intra_plain(c, b, x, cum):
    """Plain PyTorch version (``repro.kernels.ref.ssd_intra_ref``):
    c, b (G, Q, N); x (G, Q, P); cum (G, Q) -> (G, Q, P) fp32."""
    return ssd_intra_ref(c, b, x, cum)


def ssd_intra_chunks_plain(C, B, x, cum):
    """Plain version of the model's launch, as ``ssd_chunked`` writes
    its intra-chunk term: C, B (b, nc, Q, G, N); x (b, nc, Q, H, P);
    cum (b, nc, Q, H) -> (b, nc, Q, H, P) fp32."""
    q, h = x.shape[2], x.shape[3]
    rep = h // C.shape[3]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (b,nc,Q,Q,H)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=x.device))[None, None, :, :, None]
    decay = torch.where(mask, torch.exp(diff.float()), 0.0)
    scores = torch.einsum("bcign,bcjgn->bcijg", C.float(), B.float())
    scores = scores.repeat_interleave(rep, dim=-1)          # (b,nc,Q,Q,H)
    return torch.einsum("bcijh,bcjhp->bcihp", scores * decay, x.float())


_LAUNCH_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
    [ctypes.c_longlong] * 15 + [ctypes.c_void_p]


def _launch(c, b, x, cum, out, outer, heads, groups, q, n, p, strides):
    fn = _build.entry(NAME, "ssd_intra_launch", _LAUNCH_ARGS)
    with _build.on_device(x.device):
        rc = fn(c.data_ptr(), b.data_ptr(), x.data_ptr(), cum.data_ptr(),
                out.data_ptr(), outer, heads, groups, q, n, p, *strides,
                _build.stream_ptr(x.device))
    _build.check(NAME, rc)
    ssd_intra.launches += 1
    return out


def resident_warps(n: int, p: int) -> int:
    """Warps of the kernel that a launch at (N, P) takes, resident on an
    SM of the current card at once (the CUDA occupancy calculator)."""
    fn = _build.entry(NAME, "ssd_intra_resident_warps",
                      [ctypes.c_int, ctypes.c_int])
    warps = fn(n, p)
    if warps < 0:
        _build.check(NAME, -warps)
    return warps


def _check(tensors, names, n, p, q):
    dev = tensors[0].device
    for t, nm in zip(tensors, names):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_intra: {nm} must be float32 on the card, "
                            f"got {t.dtype}")
        if t.device != dev:
            raise ValueError("ssd_intra: inputs must share a device")
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_intra: the last axis of {nm} must be "
                             f"contiguous")
    if not (1 <= n <= MAX_N and 1 <= p <= MAX_P and q >= 1):
        raise ValueError(f"ssd_intra: N={n} and P={p} must lie in "
                         f"[1, {MAX_N}] and [1, {MAX_P}], Q={q} >= 1")


def ssd_intra(c, b, x, cum):
    """Fused intra-chunk SSD, ``((C B^T) ∘ tril(exp(cum_i - cum_j))) x``
    per cell. c, b: (G, Q, N); x: (G, Q, P); cum: (G, Q) -> (G, Q, P)
    fp32. A CUDA tensor launches the kernel (or raises); a CPU tensor
    takes :func:`ssd_intra_plain`."""
    g, q, n = c.shape
    p = x.shape[-1]
    if b.shape != c.shape or x.shape[:2] != (g, q) or \
            tuple(cum.shape) != (g, q):
        raise ValueError(f"ssd_intra: c, b (G, Q, N), x (G, Q, P), cum "
                         f"(G, Q) expected, got {tuple(c.shape)}, "
                         f"{tuple(b.shape)}, {tuple(x.shape)}, "
                         f"{tuple(cum.shape)}")
    if not x.is_cuda:
        return ssd_intra_plain(c, b, x, cum)
    _check((c, b, x, cum), ("c", "b", "x", "cum"), n, p, q)
    out = torch.empty((g, q, p), dtype=torch.float32, device=x.device)
    if g == 0:
        return out
    # one head per cell: the head stride is never stepped
    strides = [c.stride(0), 0, c.stride(1), b.stride(0), 0, b.stride(1),
               x.stride(0), 0, x.stride(1), cum.stride(0), 0, cum.stride(1),
               out.stride(0), 0, out.stride(1)]
    return _launch(c, b, x, cum, out, g, 1, 1, q, n, p, strides)


def ssd_intra_chunks(C, B, x, cum):
    """The model's launch: C, B (b, nc, Q, G, N); x (b, nc, Q, H, P);
    cum (b, nc, Q, H), with H a multiple of G -> (b, nc, Q, H, P) fp32,
    head h taking the B and C of group ``h // (H // G)``. The batch and
    chunk axes of each input must merge into one (stride of batch = nc
    x stride of chunk), as in any tensor made contiguous by
    ``ssd_chunked``'s reshapes. A CUDA tensor launches the
    kernel (or raises); a CPU tensor takes
    :func:`ssd_intra_chunks_plain`."""
    if not x.is_cuda:
        return ssd_intra_chunks_plain(C, B, x, cum)
    bsz, nc, q, h, p = x.shape
    g, n = C.shape[3], C.shape[4]
    if B.shape != C.shape or tuple(C.shape[:3]) != (bsz, nc, q) or \
            tuple(cum.shape) != (bsz, nc, q, h) or h % g:
        raise ValueError(f"ssd_intra_chunks: C, B (b, nc, Q, G, N), x "
                         f"(b, nc, Q, H, P), cum (b, nc, Q, H) with G | H "
                         f"expected, got {tuple(C.shape)}, {tuple(B.shape)}"
                         f", {tuple(x.shape)}, {tuple(cum.shape)}")
    _check((C, B, x, cum), ("C", "B", "x", "cum"), n, p, q)
    out = torch.empty((bsz, nc, q, h, p), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    strides = []
    for t in (C, B, x, cum, out):
        if bsz > 1 and nc > 1 and t.stride(0) != nc * t.stride(1):
            raise ValueError("ssd_intra_chunks: batch and chunk axes must "
                             "be one stride apart")
        # cell (batch i, chunk j) sits at (i * nc + j) outer strides
        outer = t.stride(1) if nc > 1 else t.stride(0)
        strides += [outer, t.stride(3), t.stride(2)]
    return _launch(C, B, x, cum, out, bsz * nc, h, g, q, n, p, strides)


ssd_intra.launches = 0
