"""Live k-means serving on the port: a streaming fit publishing into a
served index.

Two threads, one index:

* a fitter drives ``StreamingKMeans.fit_stream`` over a sharded point
  stream with ``attach_index(index)``: every committed mini-batch
  publishes fresh centroids into the double-buffered
  :class:`repro_torch.serve.CentroidIndex`;
* the main thread runs a :class:`repro_torch.serve.ServeEngine`,
  submitting ragged query blocks while the fit runs. Each response
  carries the epoch that labelled it, so the refresh shows as the epoch
  climbs mid-traffic.

  PYTHONPATH=src python -m repro_torch.examples.serve_kmeans \
      [--smoke] [--device cpu]
"""
import argparse
import threading
import time

import numpy as np

from repro_torch.data import PointStream, make_points
from repro_torch.serve import CentroidIndex, ServeEngine
from repro_torch.streaming import StreamingKMeans
from repro_torch.tune import ServeConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small sizes and short traffic")
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--dims", type=int, default=16)
    ap.add_argument("--shards", type=int, default=None,
                    help="stream length (default 24, 8 with --smoke)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    shards = args.shards or (8 if args.smoke else 24)

    stream = PointStream(512, n_shards=shards, n_dims=args.dims,
                         k=args.k, seed=0)
    index = CentroidIndex(rebuild_threshold=0.05, device=args.device)
    skm = StreamingKMeans(args.k, seed=0, init_size=1024,
                          device=args.device).attach_index(index)

    # the first shards run before traffic starts (the init lands
    # first), the rest refresh the index live under load
    batches = [stream.global_batch(i) for i in range(shards)]
    warm = max(2, -(-1024 // 512))
    skm.fit_stream(batches[:warm])
    fitter = threading.Thread(
        target=lambda: skm.fit_stream(batches[warm:]), daemon=True)

    queries, _, _ = make_points(8192, args.dims, args.k, seed=7)
    queries = np.ascontiguousarray(queries, np.float32)
    cfg = ServeConfig(max_batch=4096)
    rng = np.random.default_rng(3)
    served = 0
    epochs_seen = []
    with ServeEngine(index, config=cfg, tune="off") as eng:
        # every serve bucket once before the clock starts
        b = cfg.min_bucket
        while b <= cfg.max_batch:
            eng.assign(queries[:b])
            b *= 2
        fitter.start()
        t0 = time.perf_counter()
        # ragged blocks while the fit is live, a breather between
        # requests so the fitter shares the host
        deadline = t0 + (4.0 if args.smoke else 10.0)
        while time.perf_counter() < deadline:
            m = int(rng.integers(64, 2048))
            lo = int(rng.integers(0, queries.shape[0] - m))
            labels, epoch = eng.assign(queries[lo:lo + m])
            served += labels.shape[0]
            if not epochs_seen or epoch != epochs_seen[-1]:
                epochs_seen.append(epoch)
                print(f"[serve] epoch -> {epoch} "
                      f"(rebuilds={index.rebuilds} reuses={index.reuses})")
            if not fitter.is_alive() and len(epochs_seen) > 1:
                break
            time.sleep(0.002)
        elapsed = time.perf_counter() - t0
    fitter.join(timeout=60)
    pps = served / max(elapsed, 1e-9)
    print(f"[serve] {served} points in {elapsed * 1e3:.0f}ms "
          f"({pps:.0f} pts/s) across epochs {epochs_seen} "
          f"(publishes={index.publishes})")
    return served, epochs_seen


if __name__ == "__main__":
    main()
