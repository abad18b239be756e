"""Variants of three dry-run cells against their baselines (port of
``repro.launch.hillclimb``): the hypothesis -> change -> before ->
after lines, over the port's dry-run records (``launch.dryrun``).

Cells:
  * hymba-1.5b / train_4k
  * qwen2-7b / prefill_32k
  * kpynq-kmeans / fit

The variants are the reference's. Knobs that change nothing the port
computes are run and printed as such, not dropped: ``attn_cp`` and
``causal_slice`` (``configs/base.py``: kept so a config carries
across by name). A knob the port's k-means fit lacks (``opt_sq``) is
printed as missing.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb [--force]
"""
from __future__ import annotations

import dataclasses

from ..configs import get_config
from .dryrun import run_cell, run_kmeans_cell

# config fields that change no value, FLOP or byte of the port's step
INERT = ("attn_cp", "causal_slice")


def _fmt(rec):
    if not rec or not rec.get("ok"):
        return "MISSING/FAIL"
    rl = rec["roofline"]
    return (f"C={rl['t_compute_s']:.3e} M={rl['t_memory_s']:.3e} "
            f"N={rl['t_collective_s']:.3e} dom={rl['bottleneck']} "
            f"frac={rl.get('roofline_fraction', 0):.5f}")


def _inert(kw) -> str:
    names = [k for k in kw if k in INERT]
    return f"  (no effect in the port: {', '.join(names)})" if names else ""


def run_variant(arch, shape, tag, cfg_kw, force=False):
    cfg = dataclasses.replace(get_config(arch), **cfg_kw)
    return run_cell(arch, shape, False, force=force, cfg_override=cfg,
                    tag=f"__{tag}")


def main(force: bool = False):
    ssm = get_config("hymba-1.5b").ssm
    print("=== hillclimb: hymba-1.5b train_4k ===")
    base = run_cell("hymba-1.5b", "train_4k", False, force=force)
    print("  baseline:", _fmt(base))
    for tag, kw in [
        ("opt_dp2d", dict(batch_2d=True)),
        ("opt_chunk64", dict(ssm=dataclasses.replace(ssm, chunk=64))),
        ("opt_dp2d_chunk64", dict(batch_2d=True,
                                  ssm=dataclasses.replace(ssm, chunk=64))),
        ("opt_dp2d_c64_cp", dict(batch_2d=True, attn_cp=True,
                                 ssm=dataclasses.replace(ssm, chunk=64))),
        ("opt_dp2d_c16_cp", dict(batch_2d=True, attn_cp=True,
                                 ssm=dataclasses.replace(ssm, chunk=16))),
        ("opt_full", dict(batch_2d=True, attn_cp=True, causal_slice=True,
                          ssm=dataclasses.replace(ssm, chunk=16))),
        ("opt_cp_c16_tri", dict(attn_cp=True, causal_slice=True,
                                ssm=dataclasses.replace(ssm, chunk=16))),
    ]:
        rec = run_variant("hymba-1.5b", "train_4k", tag, kw, force=force)
        print(f"  {tag:18s}:", _fmt(rec) + _inert(kw))

    print("=== hillclimb: qwen2-7b prefill_32k ===")
    base = run_cell("qwen2-7b", "prefill_32k", False, force=force)
    print("  baseline:", _fmt(base))
    for tag, kw in [
        ("opt_cp", dict(attn_cp=True)),
        ("opt_tp", dict(serve_tp_params=True)),
        ("opt_cp_tp", dict(attn_cp=True, serve_tp_params=True)),
        ("opt_tri", dict(causal_slice=True)),
        ("opt_tri_tp", dict(causal_slice=True, serve_tp_params=True)),
        ("opt_tri_cp_tp", dict(causal_slice=True, attn_cp=True,
                               serve_tp_params=True)),
    ]:
        rec = run_variant("qwen2-7b", "prefill_32k", tag, kw, force=force)
        print(f"  {tag:18s}:", _fmt(rec) + _inert(kw))

    print("=== bonus: qwen2-7b decode_32k (int8 KV cache) ===")
    base = run_cell("qwen2-7b", "decode_32k", False, force=force)
    print("  baseline:", _fmt(base))
    rec = run_variant("qwen2-7b", "decode_32k", "opt_kv8",
                      dict(kv_cache_dtype="int8", serve_tp_params=True),
                      force=force)
    print(f"  {'opt_kv8_tp':18s}:", _fmt(rec))

    print("=== hillclimb: kpynq-kmeans fit ===")
    base = run_kmeans_cell(False, force=force)
    print("  baseline:", _fmt(base))
    print(f"  {'opt_sq':18s}: MISSING (the port's sharded fit has no "
          f"opt_sq)")
    rec = run_kmeans_cell(False, force=force, tag="__opt_comp",
                          compress=True)
    print(f"  {'opt_comp':18s}:", _fmt(rec))


if __name__ == "__main__":
    import sys
    main(force="--force" in sys.argv)
