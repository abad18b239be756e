"""Causal flash attention: the CUDA kernels, their plain version and
launch counters.

Replaces the Pallas kernel ``repro/kernels/flash_attention.py``
(``flash_attention`` -> ``_flash_kernel``). ``csrc/flash_attention.cu``
holds two kernels and the note on their design and bound: one on the
bf16 tensor cores (``wgmma``) and one in fp32 FFMA. :func:`route_for`
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
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import flash_attention_ref

NAME = "flash_attention"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
TC_HEAD_DIMS = (64, 128)         # the head dims the tensor-core kernel takes
# the tensor-core kernel against the plain version, beside the element
# check at 3e-2: no query row's output may lie further than this from the
# plain one, relative to the row's norm. Late rows of a long sequence
# average many values and come out small, so a missing tile or a wrong
# rounding there can hide under 3e-2 of each element; it cannot hide
# here (tests/test_torch_lm_kernels.py plants such faults)
ROW_REL_TOL = 1e-2


def route_for(dtype, head_dim: int) -> str:
    """The kernel a CUDA launch takes: ``"tc"``, the tensor cores, for
    bf16 at a head dim of 64 or 128; ``"ffma"`` otherwise. fp32 stays on
    FFMA because the tensor cores have no IEEE fp32 mode, and fp32 is
    the strict parity route."""
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


def row_rel_err(got, want) -> float:
    """The largest ``|got_i - want_i| / |want_i|`` over the query rows
    i of two attention outputs (2-norms over the head dim, in fp32)."""
    if want.numel() == 0:
        return 0.0
    g, w = got.float(), want.float()
    return float(((g - w).norm(dim=-1)
                  / w.norm(dim=-1).clamp_min(1e-30)).max())


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


def _launch(q, k, v, out, b, s, h, kv, axes, route):
    """One launch on ``route``. ``axes`` = (batch, seq, head) axis of
    every tensor."""
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
                      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 +
                      [ctypes.c_longlong] * 12 +
                      [ctypes.c_int] * len(extra) + [ctypes.c_void_p])
    with _build.on_device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, s, h, kv, q.shape[-1], *strides, *extra,
                _build.stream_ptr(q.device))
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
    launches the kernel :func:`route_for` picks (or raises); a CPU
    tensor takes :func:`flash_attention_gqa_plain`."""
    if not q.is_cuda:
        return flash_attention_gqa_plain(q, k, v)
    _check(q, k, v, kv_axis=2)
    b, s, h, d = q.shape
    if k.shape[:2] != (b, s):
        raise ValueError(f"flash_attention_gqa: k {tuple(k.shape)} does "
                         f"not match q {tuple(q.shape)} in (B, S)")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    return _launch(q, k, v, out, b, s, h, k.shape[2], axes=(0, 1, 2),
                   route=route_for(q.dtype, d))


flash_attention.launches = 0
flash_attention.launches_tc = 0
flash_attention.launches_ffma = 0
