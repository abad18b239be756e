#!/usr/bin/env python3
"""Serving time of hymba-1.5b under two source trees of the port, in turns.

    python3 scripts/lm_serve_ab.py OLD_ROOT NEW_ROOT [--order 0,1,1,0]
        [--steps 32] [--out ab.jsonl]

Each root is a checkout of this repository (``src/repro_torch`` under
it). Turn by turn, in ``--order`` (0 the first root, 1 the second), a
fresh process imports that root's package, builds its kernels into that
root's ``build/``, makes hymba-1.5b's bf16 weights at full width and
depth from seed 0, and runs the serving path of ``chip_smoke.py`` phase
10: a prefill of 2 prompts of 2048 tokens, then ``--steps`` greedy
decode steps. It prints one JSON line a turn: the root, the median of 3
prefills after the first, and the median decode step after the first,
each a host clock ending in a card sync, beside the card's name and
power limit. Two versions are compared only within one run. Needs a
card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

TURN = r"""
import json, statistics, time, torch
from repro_torch.configs import get_config
from repro_torch.models import init_cache, init_params
from repro_torch.train import make_prefill_step, make_serve_step
cfg = get_config("hymba-1.5b")
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
params = init_params(cfg, gen, device=dev)
tokens = torch.randint(0, cfg.vocab, (2, 2048), generator=gen, device=dev)
prefill, serve = make_prefill_step(cfg), make_serve_step(cfg)
def sync():
    torch.cuda.synchronize()
pre = []
for _ in range(4):
    sync(); t = time.perf_counter()
    logits, pcache = prefill(params, {"tokens": tokens})
    sync(); pre.append((time.perf_counter() - t) * 1e3)
cache = init_cache(cfg, 2, 2048 + STEPS, device=dev)
for k, v in pcache.items():
    if k in ("k", "v"):
        cache[k][:, :, :2048] = v
    else:
        cache[k].copy_(v)
del pcache
tok = logits[:, -1, :cfg.vocab].argmax(-1, keepdim=True)
dec = []
for t in range(STEPS):
    sync(); t0 = time.perf_counter()
    lg, cache = serve(params, cache, tok, 2048 + t)
    tok = lg[:, -1, :cfg.vocab].argmax(-1, keepdim=True)
    sync(); dec.append((time.perf_counter() - t0) * 1e3)
print(json.dumps({"prefill_ms": statistics.median(pre[1:]),
                  "decode_ms": statistics.median(dec[1:]),
                  "prefill_all": pre, "decode_first": dec[0]}))
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs=2)
    ap.add_argument("--order", default="0,1,1,0")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    if not smi:
        sys.exit("lm_serve_ab: needs a card")
    lines = []
    for turn, idx in enumerate(int(i) for i in args.order.split(",")):
        root = Path(args.roots[idx]).resolve()
        env = {**os.environ, "PYTHONPATH": str(root / "src")}
        out = subprocess.run(
            [sys.executable, "-c", TURN.replace("STEPS", str(args.steps))],
            cwd=root, env=env, capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            sys.exit(f"lm_serve_ab: turn {turn} ({root}) failed:\n"
                     f"{out.stderr[-3000:]}")
        rec = {"turn": turn, "root": args.roots[idx], "card": smi,
               **json.loads(out.stdout.strip().splitlines()[-1])}
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
