"""KPynq inside the LM stack: K-means-bootstrapped MoE routing, on the
port.

  PYTHONPATH=src python -m repro_torch.examples.expert_bootstrap [--device cpu]

Expert routers are initialised to centroid directions of the
token-embedding distribution (``core.integrations.kmeans_router_init``),
so experts start as owners of coherent embedding-space regions. The
example measures routing balance (entropy and max/mean load of the
layer-0 top-1 choices) of the k-means router against the random one, on
reduced llama4-scout-17b-a16e.
"""
import argparse
import math

import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.core.integrations import kmeans_router_init
from repro_torch.device import resolve_device
from repro_torch.models import init_params


def routing_stats(params, cfg, tokens):
    """(entropy of the layer-0 top-1 load, max over mean load) of
    ``tokens`` routed on their embeddings."""
    embeds = F.embedding(tokens.reshape(-1).long(), params["embed"]).float()
    router = params["layers"]["moe"]["router"][0].float()   # layer 0
    top1 = torch.argmax(embeds @ router, dim=-1)
    counts = torch.bincount(top1, minlength=cfg.n_experts).double()
    probs = counts / counts.sum()
    entropy = -torch.sum(torch.where(probs > 0, probs * torch.log(probs),
                                     torch.zeros_like(probs)))
    return float(entropy), float(counts.max() / counts.mean())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("llama4-scout-17b-a16e").reduced()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    tokens = torch.randint(0, cfg.vocab, (4, 512), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(1))

    ent_rand, load_rand = routing_stats(params, cfg, tokens)
    params_km = kmeans_router_init(params, cfg, tokens)
    ent_km, load_km = routing_stats(params_km, cfg, tokens)

    print(f"[expert_bootstrap] experts={cfg.n_experts} "
          f"(max entropy {math.log(cfg.n_experts):.2f})")
    print(f"  random router: entropy={ent_rand:.3f} "
          f"max/mean load={load_rand:.2f}")
    print(f"  kmeans router: entropy={ent_km:.3f} "
          f"max/mean load={load_km:.2f}")
    print("  -> kmeans init gives experts coherent embedding regions "
          "at near-balanced load")
    return (ent_rand, load_rand), (ent_km, load_km)


if __name__ == "__main__":
    main()
