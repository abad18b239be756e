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

Training: :func:`ssd_intra_chunks` on CUDA tensors that need a gradient
goes through :class:`SSDIntraChunks`, an autograd Function whose
forward is the same launch and whose backward is
:func:`ssd_intra_chunks_bwd`, the hand-written kernel of
``csrc/ssd_intra_bwd.cu`` (counted on
``ssd_intra_chunks_bwd.launches``); beside it,
:func:`ssd_intra_chunks_bwd_plain` writes the gradient formulas out in
plain torch. Under ``no_grad`` the launch is the serving one. On a CPU
tensor autograd differentiates the plain forward.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import ssd_intra_ref

NAME = "ssd_intra"
BWD_NAME = "ssd_intra_bwd"
MAX_N = 128
MAX_P = 128
Q_CELL = 128        # the rows of a chunk one backward cell block takes


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
    decay = _decay(cum, q)
    scores = torch.einsum("bcign,bcjgn->bcijg", C.float(), B.float())
    scores = repeat_groups(scores, rep)                     # (b,nc,Q,Q,H)
    return torch.einsum("bcijh,bcjhp->bcihp", scores * decay, x.float())


def _decay(cum, q):
    """(b, nc, Q, Q, H) ``exp(cum_i - cum_j)`` on and below the diagonal,
    0 above it. The exponent is masked to -inf before ``exp``, so the
    value above the diagonal (where exp may overflow) never enters a
    product, nor its gradient."""
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (b,nc,Q,Q,H)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=cum.device))[None, None, :, :, None]
    return torch.exp(diff.float().masked_fill(~mask, -torch.inf))


def repeat_groups(t, rep: int, dim: int = -1):
    """Axis ``dim``'s groups repeated ``rep`` times each (group g ->
    heads g * rep .. g * rep + rep - 1), by a broadcast: its gradient
    is a sum over the broadcast axis, where ``repeat_interleave``'s may
    be an atomic ``index_add_`` on the card, whose order changes from
    run to run."""
    if rep == 1:
        return t
    dim %= t.dim()
    shape = list(t.shape)
    return t.unsqueeze(dim + 1).expand(*shape[:dim + 1], rep,
                                       *shape[dim + 1:]).flatten(dim, dim + 1)


def ssd_intra_chunks_bwd_plain(C, B, x, cum, dy):
    """Plain version of :func:`ssd_intra_chunks_bwd`: with
    ``M_ij = (c_i . b_j) exp(cum_i - cum_j)`` for j <= i and
    ``dS_ij = dy_i . x_j``, returns fp32 ``(dC, dB, dx, dcum)``:
    ``dx = M^T dy``, ``dC = (dS o L) B``, ``dB = (dS o L)^T C`` (summed
    over each group's heads) and ``dcum_i = sum_j (dS o M)_ij -
    sum_k (dS o M)_ki``."""
    q, h = x.shape[2], x.shape[3]
    g = C.shape[3]
    rep = h // g
    Cf, Bf, xf, dyf = C.float(), B.float(), x.float(), dy.float()
    decay = _decay(cum, q)                                  # (b,nc,i,j,H)
    gram = repeat_groups(torch.einsum("bcign,bcjgn->bcijg", Cf, Bf), rep)
    m = gram * decay
    ds = torch.einsum("bcihp,bcjhp->bcijh", dyf, xf)
    dx = torch.einsum("bcijh,bcihp->bcjhp", m, dyf)
    w = ds * decay
    wg = w.reshape(*w.shape[:4], g, rep).sum(-1)            # (b,nc,i,j,G)
    dC = torch.einsum("bcijg,bcjgn->bcign", wg, Bf)
    dB = torch.einsum("bcijg,bcign->bcjgn", wg, Cf)
    z = ds * m
    dcum = z.sum(3) - z.sum(2)
    return dC, dB, dx, dcum


_LAUNCH_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
    [ctypes.c_longlong] * 15 + [ctypes.c_void_p]


def _launch(c, b, x, cum, out, outer, heads, groups, q, n, p, strides):
    fn = _build.entry(NAME, "ssd_intra_launch", _LAUNCH_ARGS)
    with _build.on_device(x.device):
        rc = fn(c.data_ptr(), b.data_ptr(), x.data_ptr(), cum.data_ptr(),
                out.data_ptr(), outer, heads, groups, q, n, p, *strides,
                _build.stream_ptr(x.device))
    _build.check(NAME, rc)
    _build.count_launch(ssd_intra)
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
    kernel (or raises), through :class:`SSDIntraChunks` where autograd
    records; a CPU tensor takes :func:`ssd_intra_chunks_plain`."""
    if not x.is_cuda:
        return ssd_intra_chunks_plain(C, B, x, cum)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (C, B, x, cum)):
        return SSDIntraChunks.apply(C, B, x, cum, False)
    return _chunks_forward(C, B, x, cum)


def _chunks_forward(C, B, x, cum):
    """The model's forward launch on CUDA tensors."""
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


_BWD_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def ssd_intra_chunks_bwd(C, B, x, cum, dy):
    """Gradients ``(dC, dB, dx, dcum)`` of :func:`ssd_intra_chunks` at
    (C, B, x, cum) for the output gradient ``dy`` (b, nc, Q, H, P), all
    fp32 and shaped as the inputs. A CUDA tensor launches
    ``csrc/ssd_intra_bwd.cu`` (two blocks a cell, one for dC, dB and
    dcum, one for dx, then a fixed-order sum of each group's heads: no
    atomics, two calls give the same bits). A chunk of more than
    ``Q_CELL`` rows takes the .cu's wide route: the cell's causal Q x Q
    in tiles of ``Q_CELL`` on and below the diagonal, their partials in
    a workspace added in a fixed order, the same bits twice as well. It
    raises for a shape neither takes; a CPU tensor takes
    :func:`ssd_intra_chunks_bwd_plain`."""
    if not x.is_cuda:
        return ssd_intra_chunks_bwd_plain(C, B, x, cum, dy)
    bsz, nc, q, h, p = x.shape
    g, n = C.shape[3], C.shape[4]
    if B.shape != C.shape or tuple(C.shape[:3]) != (bsz, nc, q) or \
            tuple(cum.shape) != (bsz, nc, q, h) or dy.shape != x.shape or \
            h % g:
        raise ValueError(f"ssd_intra_chunks_bwd: C, B (b, nc, Q, G, N), x "
                         f"and dy (b, nc, Q, H, P), cum (b, nc, Q, H) with "
                         f"G | H expected, got {tuple(C.shape)}, "
                         f"{tuple(B.shape)}, {tuple(x.shape)}, "
                         f"{tuple(dy.shape)}, {tuple(cum.shape)}")
    _check((C, B, x, cum, dy), ("C", "B", "x", "cum", "dy"), n, p, q)
    C, B, x, cum, dy = (t.contiguous() for t in (C, B, x, cum, dy))
    dC, dB, dx, dcum = (torch.empty_like(t) for t in (C, B, x, cum))
    if x.numel() == 0:
        return dC.zero_(), dB.zero_(), dx, dcum
    outer = bsz * nc
    ptrs = [t.data_ptr() for t in (C, B, x, cum, dy, dC, dB, dx, dcum)]
    if q <= Q_CELL:
        pc = torch.empty((outer, h, q, n), dtype=torch.float32,
                         device=x.device)
        pb = torch.empty_like(pc)
        fn = _build.entry(BWD_NAME, "ssd_intra_bwd_launch", _BWD_ARGS)
        work = [pc.data_ptr(), pb.data_ptr()]
    else:
        floats = _build.entry(BWD_NAME, "ssd_intra_bwd_wide_floats",
                              [ctypes.c_int] * 5, ctypes.c_longlong)
        ws = torch.empty((floats(outer, h, q, n, p),), dtype=torch.float32,
                         device=x.device)
        fn = _build.entry(BWD_NAME, "ssd_intra_bwd_wide_launch",
                          [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 +
                          [ctypes.c_void_p])
        work = [ws.data_ptr()]
    with _build.on_device(x.device):
        rc = fn(*ptrs, *work, outer, h, g, q, n, p,
                _build.stream_ptr(x.device))
    _build.check(BWD_NAME, rc)
    _build.count_launch(ssd_intra_chunks_bwd)
    return dC, dB, dx, dcum


class SSDIntraChunks(torch.autograd.Function):
    """The model's intra-chunk term with a gradient: forward the launch
    of :func:`ssd_intra_chunks`, backward :func:`ssd_intra_chunks_bwd`
    (the four inputs saved). ``plain=True`` takes the plain versions of
    both instead (:func:`ssd_intra_chunks_plain_vjp`). The backward
    kernel takes any chunk."""

    @staticmethod
    def forward(ctx, C, B, x, cum, plain):
        ctx.plain = plain
        ctx.save_for_backward(C, B, x, cum)
        if plain:
            return ssd_intra_chunks_plain(C, B, x, cum)
        return _chunks_forward(C, B, x, cum)

    @staticmethod
    def backward(ctx, dy):
        C, B, x, cum = ctx.saved_tensors
        bwd = ssd_intra_chunks_bwd_plain if ctx.plain else \
            ssd_intra_chunks_bwd
        return (*bwd(C, B, x, cum, dy.contiguous()), None)


def ssd_intra_chunks_plain_vjp(C, B, x, cum):
    """:func:`ssd_intra_chunks_plain` whose backward is
    :func:`ssd_intra_chunks_bwd_plain`: the plain route of a training
    step."""
    return SSDIntraChunks.apply(C, B, x, cum, True)


ssd_intra.launches = 0
ssd_intra_chunks_bwd.launches = 0
