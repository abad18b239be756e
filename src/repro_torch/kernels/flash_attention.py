"""Causal flash attention: the CUDA kernels, their plain version and
launch counters.

Replaces the Pallas kernel ``repro/kernels/flash_attention.py``
(``flash_attention`` -> ``_flash_kernel``). ``csrc/flash_attention.cu``
holds two kernels and the note on their design and bound: one on the
bf16 tensor cores (``wgmma``, at head dims 64, 96 and 128) and one in
fp32 FFMA (fp32, and bf16 at any other head dim). :func:`route_for`
picks one from the dtype and the head dim alone; a CUDA tensor
launches that kernel or raises, never the other. Two wrappers launch
them and count on ``flash_attention.launches`` (every launch), and on
``flash_attention.launches_tc`` or ``flash_attention.launches_ffma``
(the kernel's own):

- :func:`flash_attention`, the reference's entry point: q, k, v
  (B, H, S, D) with the reference's checks on S and the blocks;
- :func:`flash_attention_gqa`, the model's launch: q (B, S, H, D) and
  k, v (B, S, KV, D) as the projections leave them, query head h
  reading kv head ``h // (H // KV)``, any S.

Both read their inputs through strides, so neither copies. On a CPU
tensor each takes its plain version instead.

Training: :func:`flash_attention_gqa` on CUDA tensors that need a
gradient goes through :class:`FlashAttentionGQA`, an autograd Function
whose forward is the same launch with each row's logsumexp L written
beside the output (:func:`flash_attention_gqa_with_lse`) and whose
backward is :func:`flash_attention_gqa_bwd`, the hand-written kernels
of ``csrc/flash_attention_bwd.cu``, which take L rather than recompute
it. The backward picks its kernels by :func:`route_for` as the forward
does, and counts on ``flash_attention_gqa_bwd.launches`` and on
``.launches_tc`` or ``.launches_ffma``; beside it,
:func:`flash_attention_gqa_bwd_plain` writes the gradient formulas out
in plain torch. Under ``no_grad`` the launch is the serving one, with
no Function around it and no L. On a CPU tensor autograd
differentiates the plain forward.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import flash_attention_ref

NAME = "flash_attention"
BWD_NAME = "flash_attention_bwd"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
# the head dims the tensor-core kernels take (96: MLA's q.k, minicpm3-4b)
TC_HEAD_DIMS = (64, 96, 128)
# the tensor-core kernel against the plain version, beside the element
# check at 3e-2: no query row's output may lie further than this from the
# plain one, relative to the row's norm. Late rows of a long sequence
# average many values and come out small, so a missing tile or a wrong
# rounding there can hide under 3e-2 of each element; it cannot hide
# here (tests/test_torch_lm_kernels.py plants such faults)
ROW_REL_TOL = 1e-2
# the same check for the backward: no row of dq (a query's) or of dk or
# dv (a key's) may lie further than this from the plain version, relative
# to the larger of the row's norm and BWD_ROW_FLOOR of the largest row's.
# Under the causal mask late keys' and late queries' gradients come out
# small, so a dropped tile or ring stage there hides under 3e-2 of the
# largest element, but not here (tests/test_torch_lm_kernels.py plants
# such faults). The floor keeps a row whose exact gradient is 0 (query
# 0's dq: its one key gives dS = 0) from dividing rounding by nothing.
BWD_ROW_REL_TOL = 2e-2
BWD_ROW_FLOOR = 1e-3


def route_for(dtype, head_dim: int) -> str:
    """The kernel a CUDA launch takes: ``"tc"``, the tensor cores, for
    bf16 at a head dim of 64, 96 or 128; ``"ffma"`` otherwise. fp32
    stays on FFMA because the tensor cores have no IEEE fp32 mode, and
    fp32 is the strict parity route."""
    if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS:
        return "tc"
    return "ffma"


def check_tc_operands(**tensors) -> None:
    """Raise ``ValueError`` naming the first base address or
    (batch, sequence, head) stride of a tensor-core operand that is not
    a multiple of 16 bytes: the kernel reads its tiles through tensor
    maps (TMA), which take no other."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name}'s base address is "
                             f"not 16-byte aligned")
        for axis in range(3):
            if t.shape[axis] > 1 and t.stride(axis) * t.element_size() % 16:
                raise ValueError(
                    f"flash_attention: {name}.stride({axis}) = "
                    f"{t.stride(axis)} elements is not a multiple of 16 "
                    f"bytes")


def row_rel_err(got, want, floor: float = 0.0) -> float:
    """The largest ``|got_i - want_i| / max(|want_i|, floor * max_j
    |want_j|)`` over the rows i of two attention outputs or gradients
    (2-norms over the head dim, in fp32)."""
    if want.numel() == 0:
        return 0.0
    g, w = got.float(), want.float()
    norms = w.norm(dim=-1)
    return float(((g - w).norm(dim=-1) / torch.maximum(
        norms, floor * norms.max()).clamp_min(1e-30)).max())


def flash_attention_plain(q, k, v, *, block_q: int = 256,
                          block_k: int = 256):
    """Plain PyTorch version: fp32 softmax over the causal scores
    (``repro.kernels.ref.flash_attention_ref``), output in q's dtype.
    The blocks do not change the result."""
    return flash_attention_ref(q, k, v)


def flash_attention_gqa_plain(q, k, v):
    """Plain version of the model's launch: kv heads repeated over their
    query heads, then :func:`flash_attention_plain` in (B, H, S, D)."""
    rep = q.shape[2] // k.shape[2]
    kh = k.transpose(1, 2).repeat_interleave(rep, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(rep, dim=1)
    return flash_attention_ref(q.transpose(1, 2), kh, vh).transpose(1, 2)


def _scores_plain(q, k):
    """fp32 (B, H, S, S) scores ``q_i . k_j / sqrt(D)`` of the model's
    layout, kv heads repeated, -inf above the diagonal."""
    s, h, d = q.shape[1:]
    rep = h // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2).repeat_interleave(rep, dim=1)
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    return (qf @ kf.transpose(-1, -2) / math.sqrt(d)).masked_fill(
        ~causal, -math.inf)


def flash_attention_gqa_lse_plain(q, k, v):
    """Plain version of :func:`flash_attention_gqa_with_lse`: the
    output of :func:`flash_attention_gqa_plain` and each row's
    logsumexp of its scaled causal scores, fp32 (B, H, S)."""
    return flash_attention_gqa_plain(q, k, v), torch.logsumexp(
        _scores_plain(q, k), dim=-1)


def _check(q, k, v, kv_axis):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: 4-d q, k, v with k.shape == "
                         f"v.shape expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must all be float32 or "
                        f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.device == v.device == q.device):
        raise ValueError("flash_attention: q, k, v must share a device")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim must be contiguous")
    d = q.shape[-1]
    if k.shape[-1] != d or not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} (k: {k.shape[-1]})"
                         f" must match and lie in [1, {MAX_HEAD_DIM}]")
    h, kv = q.shape[kv_axis], k.shape[kv_axis]
    if kv < 1 or h % kv:
        raise ValueError(f"flash_attention: {h} query heads are not a "
                         f"multiple of {kv} kv heads")


def _launch(q, k, v, out, b, s, h, kv, axes, route, lse=None):
    """One launch on ``route``. ``axes`` = (batch, seq, head) axis of
    every tensor; ``lse``, where given, an fp32 (B, H, S) tensor the
    kernel writes each row's logsumexp into."""
    ab, as_, ah = axes
    strides = []
    for t in (q, k, v, out):
        strides += [t.stride(ab), t.stride(as_), t.stride(ah)]
    if route == "tc":
        check_tc_operands(q=q.permute(ab, as_, ah, 3),
                          k=k.permute(ab, as_, ah, 3),
                          v=v.permute(ab, as_, ah, 3))
        symbol, extra = "flash_attention_tc_launch", []
    else:
        symbol, extra = "flash_attention_launch", [DTYPES[q.dtype]]
    fn = _build.entry(NAME, symbol,
                      [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 +
                      [ctypes.c_longlong] * 12 +
                      [ctypes.c_int] * len(extra) + [ctypes.c_void_p])
    with _build.on_device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), b, s, h, kv,
                q.shape[-1], *strides, *extra, _build.stream_ptr(q.device))
    _build.check(NAME, rc)
    _build.count_launch(flash_attention)
    if route == "tc":
        _build.count_launch(flash_attention, "launches_tc")
    else:
        _build.count_launch(flash_attention, "launches_ffma")
    return out


def launch_gqa(q, k, v, route: str):
    """The model's launch (q (B, S, H, D), k and v (B, S, KV, D), CUDA
    tensors) on the named kernel, ``"tc"`` or ``"ffma"``, whichever
    :func:`route_for` would pick: to time one kernel against the other
    on the same inputs. The wrappers never call it."""
    if route not in ("tc", "ffma"):
        raise ValueError(f"flash_attention: no route {route!r}")
    _check(q, k, v, kv_axis=2)
    if route == "tc" and route_for(q.dtype, q.shape[-1]) != "tc":
        raise ValueError(f"flash_attention: the tensor-core kernel takes "
                         f"bf16 at head dims {TC_HEAD_DIMS}, not "
                         f"{q.dtype} at {q.shape[-1]}")
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    return _launch(q, k, v, out, b, s, h, k.shape[2], (0, 1, 2), route)


def flash_attention(q, k, v, *, block_q: int = 256, block_k: int = 256):
    """Causal attention. q, k, v: (B, H, S, D) -> (B, H, S, D) in q's
    dtype (float32 or bfloat16), softmax in fp32, ``scale = 1/sqrt(D)``.

    The reference's contract: S divisible by ``block_q`` and ``block_k``
    after each is clipped to S. The blocks do not change the result;
    the kernels keep their own tiles. A CUDA tensor launches the kernel
    :func:`route_for` picks (or raises); a CPU tensor takes
    :func:`flash_attention_plain`."""
    b, h, s, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q, k, v must share one shape "
                         f"(B, H, S, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bq, bk = min(block_q, s), min(block_k, s)
    if bq < 1 or bk < 1 or s % bq or s % bk:
        raise ValueError(f"flash_attention: S={s} must be divisible by "
                         f"block_q={bq} and block_k={bk}")
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, block_q=block_q,
                                     block_k=block_k)
    _check(q, k, v, kv_axis=1)
    out = torch.empty((b, h, s, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    return _launch(q, k, v, out, b, s, h, h, axes=(0, 2, 1),
                   route=route_for(q.dtype, d))


def flash_attention_gqa(q, k, v):
    """The model's causal attention: q (B, S, H, D), k and v
    (B, S, KV, D) with H a multiple of KV -> (B, S, H, D) in q's dtype,
    softmax in fp32, ``scale = 1/sqrt(D)``, any S. A CUDA tensor
    launches the kernel :func:`route_for` picks (or raises), through
    :class:`FlashAttentionGQA` where autograd records (a gradient is
    asked of q, k or v); a CPU tensor takes
    :func:`flash_attention_gqa_plain`."""
    if not q.is_cuda:
        return flash_attention_gqa_plain(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionGQA.apply(q, k, v, False)
    return _gqa_forward(q, k, v)[0]


def flash_attention_gqa_with_lse(q, k, v):
    """The model's launch with L: ``(out, lse)``, the output of
    :func:`flash_attention_gqa` and each row's logsumexp of its scaled
    causal scores, fp32 (B, H, S) in natural-log units on both kernels
    (what :func:`flash_attention_gqa_bwd` takes). A CUDA tensor
    launches the kernel :func:`route_for` picks (one launch, counted as
    the serving one is); a CPU tensor takes
    :func:`flash_attention_gqa_lse_plain`."""
    if not q.is_cuda:
        return flash_attention_gqa_lse_plain(q, k, v)
    return _gqa_forward(q, k, v, with_lse=True)


def _gqa_forward(q, k, v, with_lse=False):
    """The model's forward launch on CUDA tensors: ``(out, lse)``, lse
    None unless ``with_lse``."""
    _check(q, k, v, kv_axis=2)
    b, s, h, d = q.shape
    if k.shape[:2] != (b, s):
        raise ValueError(f"flash_attention_gqa: k {tuple(k.shape)} does "
                         f"not match q {tuple(q.shape)} in (B, S)")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if out.numel() == 0:
        return out, lse
    _launch(q, k, v, out, b, s, h, k.shape[2], axes=(0, 1, 2),
            route=route_for(q.dtype, d), lse=lse)
    return out, lse


def flash_attention_gqa_bwd_plain(q, k, v, o, do, lse=None):
    """Plain version of :func:`flash_attention_gqa_bwd`: the gradient
    formulas written out in fp32, P = exp(scores - L) from the given L
    (the softmax of the scores where ``lse`` is None), D from o and dO,
    dK and dV summed over each kv head's query heads; grads in the
    inputs' dtypes."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    rep = h // kv
    scale = 1.0 / math.sqrt(d)
    qf, of, gf = (t.float().transpose(1, 2) for t in (q, o, do))
    kf, vf = (t.float().transpose(1, 2).repeat_interleave(rep, dim=1)
              for t in (k, v))
    sc = _scores_plain(q, k)
    p = torch.softmax(sc, dim=-1) if lse is None else \
        torch.exp(sc - lse.float()[..., None])           # (B, H, S, S)
    dv = p.transpose(-1, -2) @ gf
    dp = gf @ vf.transpose(-1, -2)
    delta = (gf * of).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = ds @ kf * scale
    dk = ds.transpose(-1, -2) @ qf * scale

    def group(t):                        # (B, H, S, D) -> (B, S, KV, D)
        return t.reshape(b, kv, rep, s, d).sum(2).transpose(1, 2)

    return (dq.transpose(1, 2).to(q.dtype), group(dk).to(k.dtype),
            group(dv).to(v.dtype))


_BWD_ARGS = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_BWD_TILE = 64                   # rows of the backward's tiles


def flash_attention_gqa_bwd(q, k, v, o, do, lse):
    """Gradients ``(dq, dk, dv)`` of :func:`flash_attention_gqa` at
    (q, k, v), whose output was ``o`` and whose rows' logsumexp was
    ``lse`` (fp32 (B, H, S), from :func:`flash_attention_gqa_with_lse`),
    for the output gradient ``do`` (all (B, S, H or KV, D), one dtype,
    fp32 or bf16), in the inputs' dtypes. A CUDA tensor launches
    ``csrc/flash_attention_bwd.cu`` on the route :func:`route_for`
    picks (no atomics: two calls give the same bits) or raises; a CPU
    tensor takes :func:`flash_attention_gqa_bwd_plain`."""
    if not q.is_cuda:
        return flash_attention_gqa_bwd_plain(q, k, v, o, do, lse)
    return _bwd_launch(q, k, v, o, do, lse, route_for(q.dtype, q.shape[-1]))


def launch_gqa_bwd(q, k, v, o, do, lse, route: str):
    """:func:`flash_attention_gqa_bwd` on CUDA tensors on the named
    kernels, ``"tc"`` or ``"ffma"``, whichever :func:`route_for` would
    pick: to time one route against the other on the same inputs. The
    wrappers never call it."""
    if route not in ("tc", "ffma"):
        raise ValueError(f"flash_attention_bwd: no route {route!r}")
    if route == "tc" and route_for(q.dtype, q.shape[-1]) != "tc":
        raise ValueError(f"flash_attention_bwd: the tensor-core kernels "
                         f"take bf16 at head dims {TC_HEAD_DIMS}, not "
                         f"{q.dtype} at {q.shape[-1]}")
    return _bwd_launch(q, k, v, o, do, lse, route)


def _bwd_launch(q, k, v, o, do, lse, route):
    _check(q, k, v, kv_axis=2)
    b, s, h, d = q.shape
    kv = k.shape[2]
    if k.shape[:2] != (b, s) or o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_attention_gqa_bwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)} do not match")
    if o.dtype != q.dtype or do.dtype != q.dtype or \
            o.device != q.device or do.device != q.device:
        raise TypeError("flash_attention_gqa_bwd: o and do must share q's "
                        "dtype and device")
    if lse is None or tuple(lse.shape) != (b, h, s) or \
            lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"flash_attention_gqa_bwd: lse must be the "
                         f"forward's fp32 ({b}, {h}, {s}) on q's device")
    q, k, v, o, do, lse = (t.contiguous() for t in (q, k, v, o, do, lse))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    tc = route == "tc"
    if tc:
        check_tc_operands(q=q, k=k, v=v, do=do)
    s_pad = -(-s // _BWD_TILE) * _BWD_TILE
    lpad = torch.empty((b, h, s_pad), dtype=torch.float32, device=q.device)
    dpad = torch.empty_like(lpad)
    # the tc route's per-head fp32 partials of dK and dV
    dkp, dvp = (torch.empty((b, h, s, d), dtype=torch.float32,
                            device=q.device) if tc else None
                for _ in range(2))
    fn = _build.entry(BWD_NAME, "flash_attention_bwd_launch", _BWD_ARGS)
    with _build.on_device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), lpad.data_ptr(), dpad.data_ptr(),
                dkp.data_ptr() if tc else None,
                dvp.data_ptr() if tc else None, b, s, h, kv, d,
                DTYPES[q.dtype], int(tc), _build.stream_ptr(q.device))
    _build.check(BWD_NAME, rc)
    _build.count_launch(flash_attention_gqa_bwd)
    _build.count_launch(flash_attention_gqa_bwd,
                        "launches_tc" if tc else "launches_ffma")
    return dq, dk, dv


class FlashAttentionGQA(torch.autograd.Function):
    """The model's attention with a gradient: forward the launch of
    :func:`flash_attention_gqa_with_lse`, backward
    :func:`flash_attention_gqa_bwd` (q, k, v, the output and L saved;
    under remat the recomputed forward writes and saves L again).
    ``plain=True`` takes the plain versions of both instead
    (:func:`flash_attention_gqa_plain_vjp`), with no L."""

    @staticmethod
    def forward(ctx, q, k, v, plain):
        if plain:
            out, lse = flash_attention_gqa_plain(q, k, v), None
        else:
            out, lse = _gqa_forward(q, k, v, with_lse=True)
        ctx.plain = plain
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_attention_gqa_bwd_plain if ctx.plain else \
            flash_attention_gqa_bwd
        return (*bwd(q, k, v, o, do.contiguous(), lse), None)


def flash_attention_gqa_plain_vjp(q, k, v):
    """:func:`flash_attention_gqa_plain` whose backward is
    :func:`flash_attention_gqa_bwd_plain`: the plain route of a
    training step, launch for launch beside the kernels'."""
    return FlashAttentionGQA.apply(q, k, v, True)


flash_attention.launches = 0
flash_attention.launches_tc = 0
flash_attention.launches_ffma = 0
flash_attention_gqa_bwd.launches = 0
flash_attention_gqa_bwd.launches_tc = 0
flash_attention_gqa_bwd.launches_ffma = 0
