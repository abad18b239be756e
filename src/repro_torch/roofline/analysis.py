"""Three-term roofline of a step on one NVIDIA H100 a rank (port of
``repro.roofline.analysis``):

  compute    = FLOPs             / PEAK_FLOPS
  memory     = bytes accessed    / HBM_BW
  collective = collective bytes  / NVLINK_BW

each per rank (``launch.dryrun`` counts a rank's FLOPs and bytes on
the ``meta`` device and its collective bytes from the placements).

Hardware constants, NVIDIA H100 SXM5 data sheet (dense rates, no
sparsity, at the full 700 W power limit): 989 TFLOP/s bf16 on the
tensor cores, 3.35 TB/s HBM3, NVLink 4 at 900 GB/s a GPU in both
directions together, 450 GB/s each way.

The reference's parsers of XLA HLO text (``collective_bytes_per_device``,
``hlo_dot_flops``, ``hlo_traffic_bytes``, ``_shape_bytes``) have no
counterpart: the port compiles no HLO.
"""
from __future__ import annotations

from typing import Optional

PEAK_FLOPS = 989e12     # bf16 dense, tensor cores
HBM_BW = 3.35e12        # bytes/s
NVLINK_BW = 450e9       # bytes/s each way a GPU


def model_flops(cfg, kind: str, batch: int, seq: int) -> float:
    """6*N*D (train) / 2*N*D (inference) with MoE active-param scaling
    (the embedding, a lookup, counts nothing)."""
    from ..models.transformer import param_shapes

    def leaf_count(tree, prefix=""):
        total = 0.0
        for k, v in tree.items():
            p = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                total += leaf_count(v, p)
            else:
                n = 1
                for d in v:
                    n *= d
                name = p.split("/")[-1]
                if "moe" in p.split("/") and name != "router":
                    n *= cfg.moe_top_k / cfg.n_experts   # active fraction
                if name in ("embed",):
                    n = 0                                 # lookup, not matmul
                total += n
        return total

    n_active = leaf_count(param_shapes(cfg))
    tokens = batch * seq if kind in ("train", "prefill") else batch
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active * tokens


def roofline(cost: dict, coll_total_per_dev: float, chips: int,
             cfg=None, kind: Optional[str] = None,
             batch: int = 0, seq: int = 0) -> dict:
    """``cost``: a rank's ``{"flops", "bytes accessed"}``;
    ``coll_total_per_dev``: the bytes one rank sends in collectives."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    t_compute = flops / PEAK_FLOPS
    t_memory = byts / HBM_BW
    t_coll = coll_total_per_dev / NVLINK_BW
    dom = max(("compute", t_compute), ("memory", t_memory),
              ("collective", t_coll), key=lambda kv: kv[1])[0]
    out = {
        "per_device_flops": flops,
        "per_device_bytes": byts,
        "per_device_collective_bytes": float(coll_total_per_dev),
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "bottleneck": dom,
        "chips": chips,
    }
    if cfg is not None and kind is not None:
        mf = model_flops(cfg, kind, batch, seq)
        out["model_flops_total"] = mf
        out["model_flops_per_device"] = mf / chips
        out["useful_flops_ratio"] = (mf / chips) / flops if flops else 0.0
        # useful work over the time the dominant term implies
        t_star = max(t_compute, t_memory, t_coll)
        out["roofline_fraction"] = ((mf / chips) / PEAK_FLOPS) / t_star \
            if t_star > 0 else 0.0
    return out
