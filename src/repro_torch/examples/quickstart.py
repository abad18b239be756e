"""Quickstart: KPynq K-means in five lines, on the port.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The filtered (Yinyang) fit and Lloyd's fit from the same k-means++
seeds give the same clustering; the filters skip most of the distance
work.
"""
import argparse

import numpy as np

from repro_torch import KMeans
from repro_torch.data import make_points


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=100_000)
    args = ap.parse_args(argv)

    # 100k points, 32-dim, 64 true clusters
    points, _, _ = make_points(args.n, 32, 64, seed=0)

    km = KMeans(n_clusters=64, algorithm="yinyang",
                device=args.device).fit(points)                    # KPynq
    km_ref = KMeans(n_clusters=64, algorithm="lloyd",
                    device=args.device).fit(points)                # baseline

    print(f"inertia  kpynq={km.inertia_:.1f} lloyd={km_ref.inertia_:.1f}")
    print(f"iters    kpynq={km.n_iter_} lloyd={km_ref.n_iter_}")
    print(f"distance evaluations: kpynq={km.distance_evals_:.3g} "
          f"lloyd={km_ref.distance_evals_:.3g} "
          f"-> work reduction "
          f"{km_ref.distance_evals_ / km.distance_evals_:.1f}x")
    assert np.allclose(km.inertia_, km_ref.inertia_, rtol=1e-4), \
        "filters are exact: same clustering, less work"
    print("OK — identical clustering, fraction of the work.")
    return km, km_ref


if __name__ == "__main__":
    main()
