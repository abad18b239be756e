#!/usr/bin/env python3
"""How far apart correct bf16 attentions leave hymba-1.5b's logits.

    python3 scripts/lm_bf16_floor.py [--out floor.jsonl]

On one card, with seeded bf16 weights at full width, the prefill of 2
prompts of 2048 tokens runs through four routes that differ only in the
attention: the ``flash_attention`` kernel, its plain version, PyTorch's
``scaled_dot_product_attention`` and an attention in float64 (the SSD
term takes its plain version in the last three). For the first 1, 4,
16 and 32 layers (three prompt sets at 32) it prints, as one JSON line
each, the pairwise distances of the last-token logits as max |a - b|
over max |b|, the measure ``chip_smoke.py`` bounds. Needs a card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("lm_bf16_floor: needs a card")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import init_params
    from repro_torch.train import make_prefill_step

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    ssd_plain = cs.kernel_module("ssd_intra").ssd_intra_chunks_plain
    fla_plain = cs.kernel_module("flash_attention").flash_attention_gqa_plain
    routes = {"kernel": None, "plain": fla_plain, "sdpa": cs.sdpa_gqa,
              "float64": cs.exact_gqa}
    full = get_config("hymba-1.5b")
    params = init_params(full, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    card = cs.nvidia_smi_line()
    lines = []
    for depth, seed in [(1, 0), (4, 0), (16, 0), (32, 0), (32, 1), (32, 2)]:
        cfg = dataclasses.replace(full, n_layers=depth)
        layers = {k: ({kk: vv[:depth] for kk, vv in v.items()}
                      if isinstance(v, dict) else v[:depth])
                  for k, v in params["layers"].items()}
        p = dict(params, layers=layers)
        gen = torch.Generator(device=dev).manual_seed(100 + seed)
        tokens = torch.randint(0, full.vocab, (2, 2048), generator=gen,
                               device=dev)
        t0 = time.perf_counter()
        logits = {}
        for nm, attention in routes.items():
            route = (cs.lm_route(attention, ssd_plain) if attention
                     else contextlib.nullcontext())
            with route:
                logits[nm], _ = make_prefill_step(cfg)(p, {"tokens": tokens})
        dist = {f"{a}~{b}": float((logits[a] - logits[b]).abs().max())
                / float(logits[b].abs().max())
                for a, b in itertools.combinations(routes, 2)}
        rec = dict(depth=depth, prompts=seed, card=card,
                   seconds=time.perf_counter() - t0, **dist)
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
