"""The port's LM kernels against the JAX package's.

``repro_torch.kernels.flash_attention`` and ``ssd_intra`` (on the CPU
each takes its plain version) against the Pallas kernels run with
``interpret=True`` and against ``repro.kernels.ref``, at the shapes of
``tests/test_kernels.py``; the model's launches
(``flash_attention_gqa``, ``ssd_intra_chunks``) against the reference
oracle on heads and groups broadcast by hand. The CUDA kernels
themselves are held against the plain versions by the ``cuda``-marked
tests in ``test_torch_cuda.py``.

Tolerances are those of ``tests/test_kernels.py``: attention rtol/atol
1e-5 in fp32 and 3e-2 in bf16, ``ssd_intra`` rtol/atol 1e-5.
"""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels as tk
from repro.kernels import flash_attention, ssd_intra
from repro.kernels.ref import flash_attention_ref, ssd_intra_ref
from repro_torch.kernels import ref as tref
from test_torch_cuda import (FA_CASES, GQA_CASES, SSD_CASES, attn_inputs,
                             ssd_inputs)

fla = importlib.import_module("repro_torch.kernels.flash_attention")

DTYPES = [(jnp.float32, torch.float32, 1e-5),
          (jnp.bfloat16, torch.bfloat16, 3e-2)]


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,s,d,bq,bk", FA_CASES)
def test_flash_attention_matches_pallas(b, h, s, d, bq, bk, jdt, tdt, tol):
    q, k, v = (a.transpose(0, 2, 1, 3).copy()
               for a in attn_inputs(b, s, h, h, d, s + d))
    before = tk.flash_attention.launches
    got = tk.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                             block_q=bq, block_k=bk)
    assert tk.flash_attention.launches == before      # plain on the CPU
    assert got.dtype == tdt and got.shape == (b, h, s, d)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    for want in (flash_attention(jq, jk, jv, block_q=bq, block_k=bk,
                                 interpret=True),
                 flash_attention_ref(jq, jk, jv)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_flash_attention_keeps_the_block_contract():
    q = torch.zeros((1, 1, 96, 16))
    with pytest.raises(ValueError, match="divisible"):
        tk.flash_attention(q, q, q, block_q=64)
    with pytest.raises(ValueError, match="one shape"):
        tk.flash_attention(q, q[:, :, :64], q)
    # blocks clip to S, as the reference's do
    assert tk.flash_attention(q, q, q).shape == q.shape


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,kv,d", GQA_CASES)
def test_gqa_launch_matches_reference_oracle(b, s, h, kv, d, jdt, tdt, tol):
    q, k, v = attn_inputs(b, s, h, kv, d, s * h)
    got = tk.flash_attention_gqa(*(torch.from_numpy(a).to(tdt)
                                   for a in (q, k, v)))
    assert got.dtype == tdt and got.shape == (b, s, h, d)
    # query head i reads kv head i // (h // kv): repeat by hand
    jq = jnp.asarray(q).astype(jdt).transpose(0, 2, 1, 3)
    jk, jv = (jnp.repeat(jnp.asarray(a).astype(jdt), h // kv, axis=2)
              .transpose(0, 2, 1, 3) for a in (k, v))
    want = flash_attention_ref(jq, jk, jv).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
def test_mla_launch_matches_pallas(jdt, tdt, tol):
    """MLA's launch (minicpm3-4b's, cut to size): KV = H, q.k 96, v
    zero-padded from 64 to 96 as ``models/attention.py`` pads it; the
    port's launch against the Pallas kernel in interpret mode (blocks of
    65 rows over S 130) and the reference oracle, its padded columns
    exactly 0."""
    b, s, h, d, vd = 1, 130, 4, 96, 64
    q, k, v = attn_inputs(b, s, h, h, d, 96)
    v[..., vd:] = 0.0
    got = tk.flash_attention_gqa(*(torch.from_numpy(a).to(tdt)
                                   for a in (q, k, v)))
    assert got.dtype == tdt and got.shape == (b, s, h, d)
    assert bool((got[..., vd:] == 0).all())
    jq, jk, jv = (jnp.asarray(a).astype(jdt).transpose(0, 2, 1, 3)
                  for a in (q, k, v))
    for want in (flash_attention(jq, jk, jv, block_q=65, block_k=65,
                                 interpret=True),
                 flash_attention_ref(jq, jk, jv)):
        np.testing.assert_allclose(_np(got), _np(want.transpose(0, 2, 1, 3)),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("steep", [False, True], ids=["decay", "steep"])
@pytest.mark.parametrize("g,q,n,p", SSD_CASES)
def test_ssd_intra_matches_pallas(g, q, n, p, steep):
    c, b, x, cum = ssd_inputs(g, q, n, p, seed=g * q + n, steep=steep)
    if steep:       # the decays above the diagonal overflow fp32
        with np.errstate(over="ignore"):
            assert np.isinf(np.exp(cum[:, :1] - cum)).any()
    before = tk.ssd_intra.launches
    got = tk.ssd_intra(*(torch.from_numpy(a) for a in (c, b, x, cum)))
    assert tk.ssd_intra.launches == before            # plain on the CPU
    assert got.dtype == torch.float32 and got.shape == (g, q, p)
    assert bool(torch.isfinite(got).all())
    args = [jnp.asarray(a) for a in (c, b, x, cum)]
    for want in (ssd_intra(*args, interpret=True), ssd_intra_ref(*args)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bsz,nc,q,h,g,n,p", [
    (2, 3, 8, 4, 1, 8, 32), (1, 2, 16, 4, 2, 16, 16),
    (2, 2, 128, 5, 1, 16, 128)])
def test_ssd_intra_chunks_matches_pallas_cells(bsz, nc, q, h, g, n, p):
    rng = np.random.default_rng(q * h)
    C, B = (rng.standard_normal((bsz, nc, q, g, n)).astype(np.float32)
            for _ in range(2))
    x = rng.standard_normal((bsz, nc, q, h, p)).astype(np.float32)
    cum = np.cumsum(-np.logaddexp(rng.standard_normal((bsz, nc, q, h)), 0),
                    axis=2).astype(np.float32)
    got = tk.ssd_intra_chunks(*(torch.from_numpy(a) for a in (C, B, x, cum)))
    assert got.shape == (bsz, nc, q, h, p)
    # one (Q, N) cell per (batch, chunk, head), group h // (H // G)
    grp = np.arange(h) // (h // g)

    def cells(a):           # (bsz, nc, q, h, m) -> (bsz*nc*h, q, m)
        return jnp.asarray(a.transpose(0, 1, 3, 2, 4).reshape(-1, q,
                                                              a.shape[-1]))
    want = ssd_intra(cells(C[:, :, :, grp]), cells(B[:, :, :, grp]),
                     cells(x), jnp.asarray(cum.transpose(0, 1, 3, 2)
                                           .reshape(-1, q)), interpret=True)
    want = np.asarray(want).reshape(bsz, nc, h, q, p).transpose(0, 1, 3, 2, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_port_oracles_match_jax_oracles():
    q, k, v = (a.transpose(0, 2, 1, 3).copy()
               for a in attn_inputs(2, 40, 3, 3, 16, 1))
    got = tref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)))
    want = flash_attention_ref(*(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    c, b, x, cum = ssd_inputs(3, 24, 8, 16, seed=2)
    got = tref.ssd_intra_ref(*(torch.from_numpy(a) for a in (c, b, x, cum)))
    want = ssd_intra_ref(*(jnp.asarray(a) for a in (c, b, x, cum)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 16, "ffma"), (torch.bfloat16, 32, "ffma"),
    (torch.bfloat16, 96, "tc"), (torch.float32, 64, "ffma"),
    (torch.float32, 128, "ffma"), (torch.float32, 16, "ffma"),
    (torch.bfloat16, 80, "ffma"), (torch.float32, 96, "ffma")])
def test_flash_attention_route_by_dtype_and_head_dim(dtype, d, route):
    assert fla.route_for(dtype, d) == route
    # on the CPU neither kernel runs, whatever the route
    counts = (tk.flash_attention.launches_tc,
              tk.flash_attention.launches_ffma)
    q = torch.zeros((1, 3, 2, d), dtype=dtype)
    assert tk.flash_attention_gqa(q, q[:, :, :1], q[:, :, :1]).shape == \
        q.shape
    assert (tk.flash_attention.launches_tc,
            tk.flash_attention.launches_ffma) == counts
    if route == "ffma":
        # forcing the tensor cores where they do not take the shape
        # raises before any launch
        with pytest.raises(ValueError, match="tensor-core"):
            fla.launch_gqa(q, q[:, :, :1], q[:, :, :1], "tc")


def test_flash_attention_tc_operands_need_16_byte_strides():
    q = torch.zeros((2, 9, 4, 72), dtype=torch.bfloat16)
    fla.check_tc_operands(q=q[..., :64], k=q[:, :, :1, :64])
    # MLA's operands, 96 bf16 (192 bytes) a row: q and k as torch.cat
    # leaves them, v as F.pad does
    nope, rope = (torch.zeros((2, 9, 4, n), dtype=torch.bfloat16)
                  for n in (64, 32))
    qk = torch.cat([nope, rope], dim=-1)
    fla.check_tc_operands(q=qk, k=qk,
                          v=torch.nn.functional.pad(nope, (0, 32)))
    # 73 bf16 a row: 146 bytes (axes of one element are never stepped)
    with pytest.raises(ValueError, match=r"k\.stride\(1\) = 73 elements"):
        fla.check_tc_operands(
            k=torch.zeros((1, 9, 1, 73), dtype=torch.bfloat16)[..., :64])
    with pytest.raises(ValueError, match="v's base address"):
        fla.check_tc_operands(
            v=torch.zeros(4 * 64 + 1, dtype=torch.bfloat16)[1:]
            .view(1, 4, 1, 64))


def _tc_like(q, k, v, fault=None):
    """In plain torch, what the tensor-core kernel computes from bf16
    q, k, v (B, H, S, D): fp32 scores and softmax, P rounded to bf16 for
    P.V, the output rounded to bf16. ``fault`` plants a defect: ``tile``
    leaves out keys 0-63 for the last 64 query rows of head 0;
    ``unnormalised`` skips the division by the softmax's sum; ``fp8_p``
    rounds P to float8 e4m3 instead of bf16."""
    s, d = q.shape[-2], q.shape[-1]
    scores = q.float() @ k.float().transpose(-1, -2) / math.sqrt(d)
    keep = torch.ones(s, s, dtype=torch.bool).tril().expand(
        scores.shape).clone()
    if fault == "tile":
        keep[:, 0, s - 64:, :64] = False
    scores = scores.masked_fill(~keep, float("-inf"))
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    total = p.sum(-1, keepdim=True)
    p = p.to(torch.float8_e4m3fn if fault == "fp8_p" else torch.bfloat16)
    out = p.float() @ v.float()
    if fault != "unnormalised":
        out = out / total
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("fault", [None, "tile", "unnormalised", "fp8_p"])
@pytest.mark.parametrize("d", [64, 96, 128])
def test_flash_attention_row_check_catches_planted_faults(d, fault):
    q, k, v = (torch.from_numpy(a).transpose(1, 2).to(torch.bfloat16)
               for a in attn_inputs(1, 2048, 2, 2, d, d))
    want = fla.flash_attention_plain(q, k, v)
    got = _tc_like(q, k, v, fault)
    err = fla.row_rel_err(got, want)
    if fault is None:
        # the one extra rounding passes both checks
        np.testing.assert_allclose(_np(got), _np(want), rtol=3e-2,
                                   atol=3e-2)
        assert err <= fla.ROW_REL_TOL / 2
    else:
        assert err > 2 * fla.ROW_REL_TOL
    if fault == "fp8_p" and d != 96:
        # a rounding this coarse stays under 3e-2 of every element (at
        # d 96 one element of 393,216 crosses it, so there both checks
        # catch the fault)
        np.testing.assert_allclose(_np(got), _np(want), rtol=3e-2,
                                   atol=3e-2)


def _tc_bwd_like(q, k, v, o, do, fault=None):
    """In plain torch, what the tensor-core backward computes from bf16
    q, o, dO (B, S, H, D) and k, v (B, S, KV, D): fp32 scores, P from
    the row's L, P rounded to bf16 for dV, dS = P o (dP - D) rounded to
    bf16 for dK and dQ, grads rounded to bf16. ``fault`` plants a
    defect: ``key_tile`` never writes dK and dV of the last 64 keys;
    ``last_stage`` drops the last query tile from every key's walk;
    ``dq_first_tile`` drops key tile 0 from the walks of the last quarter
    of the query rows; ``mask`` lets each query see one key past it."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    rep = h // kv
    scale = 1.0 / math.sqrt(d)
    qf, of, gf = (t.float().transpose(1, 2) for t in (q, o, do))
    kf, vf = (t.float().transpose(1, 2).repeat_interleave(rep, dim=1)
              for t in (k, v))
    raw = qf @ kf.transpose(-1, -2) * scale
    causal = torch.ones(s, s, dtype=torch.bool).tril()
    lse = torch.logsumexp(raw.masked_fill(~causal, -math.inf), -1, True)
    seen = torch.ones(s, s, dtype=torch.bool).tril(
        1 if fault == "mask" else 0)
    p = torch.exp(raw.masked_fill(~seen, -math.inf) - lse)
    ds = p * (gf @ vf.transpose(-1, -2) - (gf * of).sum(-1, keepdim=True))
    # what the dK/dV walks and the dQ walks see
    pk, dsk, dsq = p.clone(), ds.clone(), ds.clone()
    if fault == "last_stage":
        pk[..., s - 64:, :] = 0
        dsk[..., s - 64:, :] = 0
    if fault == "dq_first_tile":
        dsq[..., s - s // 4:, :64] = 0
    dv = pk.to(torch.bfloat16).float().transpose(-1, -2) @ gf
    dk = dsk.to(torch.bfloat16).float().transpose(-1, -2) @ qf * scale
    dq = dsq.to(torch.bfloat16).float() @ kf * scale

    def group(t):                        # (B, H, S, D) -> (B, S, KV, D)
        return t.reshape(b, kv, rep, s, d).sum(2).transpose(1, 2)

    dq, dk, dv = dq.transpose(1, 2), group(dk), group(dv)
    if fault == "key_tile":
        dk[:, s - 64:] = 0
        dv[:, s - 64:] = 0
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


@pytest.mark.parametrize("fault", [None, "key_tile", "last_stage",
                                   "dq_first_tile", "mask"])
@pytest.mark.parametrize("d", [64, 96, 128])
def test_flash_attention_bwd_row_check_catches_planted_faults(d, fault):
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in attn_inputs(1, 2048, 2, 1, d, d))
    do = torch.from_numpy(np.random.default_rng(d + 1).standard_normal(
        q.shape).astype(np.float32)).to(torch.bfloat16)
    o = fla.flash_attention_gqa_plain(q, k, v)
    want = fla.flash_attention_gqa_bwd_plain(q, k, v, o, do)
    got = _tc_bwd_like(q, k, v, o, do, fault)
    errs = [fla.row_rel_err(g, w, fla.BWD_ROW_FLOOR)
            for g, w in zip(got, want)]
    scaled = [float((g.float() - w.float()).abs().max()
                    / w.float().abs().max()) for g, w in zip(got, want)]
    if fault is None:
        # P and dS rounded to bf16 pass both checks
        assert max(scaled) <= 3e-2
        assert max(errs) <= fla.BWD_ROW_REL_TOL / 2
    else:
        assert max(errs) > 2 * fla.BWD_ROW_REL_TOL
    if fault == "key_tile":
        # the late keys' dV is small: zeroed, it stays under 3e-2 of the
        # largest element
        assert scaled[2] <= 3e-2 < errs[2]
