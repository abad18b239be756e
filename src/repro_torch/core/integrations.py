"""Integrations of KPynq K-means into the LM stack (port of
``repro.core.integrations``).

``kmeans_router_init`` bootstraps a MoE model's routers from the
K-means centroids of token embeddings: each expert starts as the owner
of a region of embedding space instead of a random hyperplane.
``cluster_kv_cache`` compresses a long-context KV cache: each head's
keys are clustered with the filtered (Yinyang) fit, the port's
``core.kmeans.yinyang`` as the reference runs its own, and each head's
values are averaged within its key clusters; attention then runs over
K weighted centroids (``clustered_attention_scores``) instead of S
positions. No kernel of the port lies on this path, as no Pallas kernel
lies on the reference's.

Seeds: the reference starts each head (and the router's fit) from
``kmeans_plusplus(PRNGKey(seed + head))`` (``PRNGKey(seed)``), which
torch cannot draw; the port starts it from its own k-means++ on
``torch.Generator`` seeded ``seed + head`` (``seed``), or from the
starting centroids a caller passes (``inits``, ``init``), which is how
the parity tests hand JAX's across.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .init import kmeans_plusplus
from .kmeans import yinyang


def kmeans_router_init(params: dict, cfg, sample_tokens, seed: int = 0,
                       init=None) -> dict:
    """``params`` with every layer's MoE router re-initialised to the
    centroid directions of the sample tokens' embeddings: a Yinyang fit
    of ``cfg.n_experts`` centroids (25 iterations at most, tol 1e-4)
    from the port's k-means++ on ``torch.Generator(seed)``, or from
    ``init`` (E, D); each centroid over its norm + 1e-6, transposed to
    (D, E) in the embedding's dtype, the same for every layer. The other
    leaves are ``params``' own (not copied)."""
    if cfg.family != "moe":
        raise ValueError("router bootstrap only applies to MoE archs")
    embed = params["embed"]
    tokens = torch.as_tensor(sample_tokens, device=embed.device)
    embeds = F.embedding(tokens.reshape(-1).long(), embed).float()
    if init is None:
        gen = torch.Generator(device=embeds.device).manual_seed(seed)
        init = kmeans_plusplus(gen, embeds, cfg.n_experts)
    else:
        init = torch.as_tensor(init).to(embeds.device, torch.float32)
    c = yinyang(embeds, init, max_iters=25, tol=1e-4).centroids
    c = c / (torch.linalg.vector_norm(c, dim=-1, keepdim=True) + 1e-6)
    router = c.T.to(embed.dtype)                            # (D, E)
    moe = dict(params["layers"]["moe"])
    moe["router"] = router.expand(cfg.n_layers, *router.shape).contiguous()
    return {**params, "layers": {**params["layers"], "moe": moe}}


def cluster_kv_head(keys, values, init_centroids, *, max_iters: int = 15,
                    tol: float = 1e-3):
    """One head: keys (S, Dh) clustered from ``init_centroids`` (K, Dh)
    by the filtered fit; returns fp32 ``(centroids (K, Dh), value means
    (K, Dh), counts (K,))``, a value mean over its cluster's positions
    (0 for an empty cluster)."""
    k = init_centroids.shape[0]
    res = yinyang(keys.float(), init_centroids.float(), max_iters=max_iters,
                  tol=tol)
    onehot = F.one_hot(res.assignments.long(), k).float()   # (S, K)
    cnt = onehot.sum(0)
    v_mean = (onehot.T @ values.float()) / torch.clamp(cnt[:, None],
                                                       min=1.0)
    return res.centroids, v_mean, cnt


def cluster_kv_cache(k_cache, v_cache, n_clusters: int, seed: int = 0,
                     inits=None):
    """Compress (S, H, Dh) keys and values to ``(key centroids
    (K, H, Dh), value means (K, H, Dh), counts (K, H))``, fp32, on the
    cache's device. ``inits``: per-head starting centroids (H, K, Dh);
    ``None`` seeds head h with the port's k-means++ from
    ``torch.Generator(seed + h)``."""
    s, h, dh = k_cache.shape
    ks, vs, counts = [], [], []
    for head in range(h):
        pts = k_cache[:, head].float()
        if inits is None:
            gen = torch.Generator(device=pts.device).manual_seed(seed + head)
            init = kmeans_plusplus(gen, pts, n_clusters)
        else:
            init = torch.as_tensor(inits[head]).to(pts.device, torch.float32)
        c, v, cnt = cluster_kv_head(pts, v_cache[:, head], init)
        ks.append(c)
        vs.append(v)
        counts.append(cnt)
    return (torch.stack(ks, dim=1), torch.stack(vs, dim=1),
            torch.stack(counts, dim=1))


def clustered_attention_scores(q, k_centroids, counts, scale: float):
    """Attention over clustered keys, ``softmax(q . k_c * scale +
    log n_c)``: q (H, Dh), k_centroids (K, H, Dh), counts (K, H) ->
    (H, K) fp32; each centroid stands for n_c positions."""
    scores = torch.einsum("hd,khd->hk", q.float(), k_centroids) * scale
    scores = scores + torch.log(torch.clamp(counts.T, min=1.0))
    return torch.softmax(scores, dim=-1)
