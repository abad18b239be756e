"""End to end: train a ~100M-parameter LM for a few hundred steps
on a learnable synthetic corpus, with fault-tolerant checkpointing, on
the port (counterpart of ``examples/train_lm.py``).

  PYTHONPATH=src python -m repro_torch.examples.train_lm           # ~100M
  PYTHONPATH=src python -m repro_torch.examples.train_lm --tiny --steps 60

The corpus is a deterministic affine token chain (t+1 = 7*t+3 mod V),
so the loss measurably collapses once the model memorises the map: a
real end-to-end learning signal, not noise-fitting. Runs on ``cuda``
unless ``--device cpu``.
"""
import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models.transformer import flatten_with_path, param_shapes
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import ResilientLoop
from repro_torch.train import init_train_state, make_train_step


def lm_100m() -> ArchConfig:
    # ~102M params: 12L, d=768, 12H, ff=3072, vocab=8192 (GPT-2-small-ish)
    return ArchConfig(
        name="repro-lm-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=12, head_dim=64, d_ff=3072, vocab=8192,
        q_chunk=256, loss_chunk=256, dtype="float32", remat="none")


def lm_tiny() -> ArchConfig:
    return dataclasses.replace(lm_100m(), n_layers=2, d_model=128,
                               n_heads=4, n_kv_heads=4, head_dim=32,
                               d_ff=512, vocab=512, name="repro-lm-tiny")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = lm_tiny() if args.tiny else lm_100m()
    n_params = sum(int(np.prod(s))
                   for _, s in flatten_with_path(param_shapes(cfg)))
    print(f"[train_lm] {cfg.name}: {n_params / 1e6:.1f}M params")

    seq = [0]
    for _ in range(200_000):
        seq.append((seq[-1] * 7 + 3) % cfg.vocab)
    corpus = np.asarray(seq, dtype=np.int32)

    pipeline = TokenPipeline(cfg, args.batch, args.seq, seed=0,
                             corpus=corpus)
    opt = AdamWConfig(lr_peak=1e-3, warmup_steps=max(args.steps // 10, 10),
                      decay_steps=args.steps)
    step_fn = make_train_step(cfg, opt)
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)

    loop = ResilientLoop(step_fn, pipeline, args.ckpt_dir,
                         ckpt_every=max(args.steps // 4, 25))
    loop.run(state, args.steps)
    losses = [m["loss"] for m in loop.metrics_log]
    n = max(len(losses) // 10, 1)
    print(f"[train_lm] loss: start={np.mean(losses[:n]):.3f} "
          f"end={np.mean(losses[-n:]):.3f} "
          f"({np.mean(losses[:n]) / max(np.mean(losses[-n:]), 1e-9):.1f}x "
          f"drop)")
    print(f"[train_lm] mean step time "
          f"{np.mean([m['dt'] for m in loop.metrics_log[2:]]) * 1e3:.0f} ms")
    return loop


if __name__ == "__main__":
    main()
