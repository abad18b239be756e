"""Device-resident per-iteration telemetry ring: layout + host-side
consumers (port of ``repro.obs.ring``).

The port's loop reads one set of exit scalars per iteration and no
more, so the per-iteration dynamics (candidate survival, group
pruning, bucket transitions, drift) stay on the device: a fixed
``(max_iters + 1, N_COUNTERS)`` buffer rides in the loop carry
(``EngineCarry.ring``), each loop body writes one row at its iteration
index by an indexed write with no host read, the epilogue writes the
final row, and the whole buffer is drained ONCE at fit exit
(``EngineStats.ring``), in the one transfer that also brings the fit's
exit scalars home. ``host_syncs`` is unchanged by construction.

The port's ring is **float64** on the device (the reference's is
fp32): one iteration's pairs reach about 1.7e8 at the paper suite's
uci-xlarge, above 2^24, and the port counts ``distance_evals`` in
int64, so only a float64 column keeps ``init_evals + sum(evals column)
== distance_evals`` exact at full size.

Row layout (``RING_COLUMNS``):

======  =================  ==============================================
index   column             semantics (per completed iteration)
======  =================  ==============================================
0       ``n_cand``         pending candidate count after this
                           iteration's move (points the NEXT pass must
                           score)
1       ``gmax``           surviving-group high-water observed by the
                           candidate pass that ran this iteration (0 for
                           the oracle/kernel passes, which don't compact)
2       ``shift``          max centroid drift of this iteration's move
3       ``evals``          distance evaluations ADDED this iteration
                           (candidate-pass pairs + own-distance
                           refreshes), so ``init_evals + sum(evals
                           column) == result.distance_evals`` exactly
                           (the final row is the epilogue's pending pass)
4       ``cap_n``          active point-capacity bucket (N for the
                           non-compacting backends)
5       ``cap_g``          active group-capacity bucket
6       ``inertia_proxy``  running sum of squared upper bounds — an
                           upper-bound estimate of inertia (weighted
                           when the fit is); the final (epilogue) row
                           holds the EXACT inertia
7       ``tightened``      own-distance refreshes spent this iteration
======  =================  ==============================================

Per-shard rings (the sharded fit, :mod:`repro_torch.core.distributed`)
stack along a leading shard axis, and :func:`reduce_shard_rings` produces
the global view (sums for additive columns, maxima for high-waters and
capacities).
"""
from __future__ import annotations

import numpy as np

RING_COLUMNS = ("n_cand", "gmax", "shift", "evals", "cap_n", "cap_g",
                "inertia_proxy", "tightened")
N_COUNTERS = len(RING_COLUMNS)

# column indices, importable by name
COL_N_CAND = 0
COL_GMAX = 1
COL_SHIFT = 2
COL_EVALS = 3
COL_CAP_N = 4
COL_CAP_G = 5
COL_INERTIA = 6
COL_TIGHTENED = 7

# reduction rule per column when joining per-shard rings: additive
# counters sum, high-waters / capacities / drift take the max (drift is
# replicated across shards — max == the common value)
_REDUCE_SUM = (COL_N_CAND, COL_EVALS, COL_INERTIA, COL_TIGHTENED)
_REDUCE_MAX = (COL_GMAX, COL_SHIFT, COL_CAP_N, COL_CAP_G)


def reduce_shard_rings(shard_rings) -> np.ndarray:
    """Join per-shard rings ``(S, R, C)`` into the global ``(R, C)``
    view: candidate counts / evals / inertia proxies sum across shards,
    group high-waters and capacity levels take the worst shard, and the
    (replicated) drift column is unchanged by its max. Float64, as the
    port's rings are."""
    r = np.asarray(shard_rings, np.float64)
    if r.ndim != 3 or r.shape[-1] != N_COUNTERS:
        raise ValueError(f"expected (S, R, {N_COUNTERS}) shard rings, "
                         f"got shape {r.shape}")
    out = np.zeros(r.shape[1:], np.float64)
    out[:, list(_REDUCE_SUM)] = r[:, :, list(_REDUCE_SUM)].sum(axis=0)
    out[:, list(_REDUCE_MAX)] = r[:, :, list(_REDUCE_MAX)].max(axis=0)
    return out


def shard_skew(shard_rings) -> np.ndarray:
    """Per-iteration work skew across shards: ``max / mean`` of the
    per-shard distance-eval increments (1.0 = perfectly balanced; the
    straggler signal under lockstep SPMD, where all shards WAIT for the
    worst one). Returns ``(R,)``; iterations with zero work report 1.0.
    """
    r = np.asarray(shard_rings, np.float64)[:, :, COL_EVALS]  # (S, R)
    mean = r.mean(axis=0)
    mx = r.max(axis=0)
    return np.where(mean > 0, mx / np.maximum(mean, 1e-12),
                    1.0).astype(np.float32)


def summarize_ring(ring, n_points: int, *, init_evals: float = 0.0) -> dict:
    """Headline telemetry of one fit's drained ring — the per-dataset
    summary the benchmark record carries. ``ring`` is the trimmed
    ``(n_iters + 1, C)`` buffer (final row = epilogue); ``n_points``
    normalises the candidate fraction."""
    ring = np.asarray(ring, np.float64)
    if ring.size == 0:
        return {"iters": 0, "mean_candidate_fraction": 0.0,
                "total_evals": float(init_evals), "mean_gmax": 0.0,
                "final_shift": 0.0}
    iters = max(ring.shape[0] - 1, 0)       # last row is the epilogue
    body = ring[:iters] if iters else ring[:0]
    n = max(float(n_points), 1.0)
    return {
        "iters": int(iters),
        "mean_candidate_fraction":
            float(body[:, COL_N_CAND].mean() / n) if iters else 0.0,
        "total_evals": float(ring[:, COL_EVALS].sum() + init_evals),
        "mean_gmax": float(body[:, COL_GMAX].mean()) if iters else 0.0,
        "final_shift": float(body[-1, COL_SHIFT]) if iters else 0.0,
    }


def caps_from_ring(ring) -> list:
    """The capacity-ladder trajectory as the host bucket picker would
    report it: consecutive distinct ``(cap_n, cap_g)`` pairs over the
    per-iteration rows (epilogue row excluded)."""
    ring = np.asarray(ring)
    caps = []
    for row in ring[:max(ring.shape[0] - 1, 0)]:
        pair = (int(row[COL_CAP_N]), int(row[COL_CAP_G]))
        if not caps or caps[-1] != pair:
            caps.append(pair)
    return caps


def format_ring_table(ring, n_points: int, *, max_rows: int = 20) -> str:
    """Human-readable per-iteration filter-efficiency table (the
    example prints this). Long fits are elided in the middle."""
    ring = np.asarray(ring, np.float64)
    rows = list(range(ring.shape[0]))
    lines = [f"{'iter':>5} {'n_cand':>9} {'cand%':>7} {'gmax':>5} "
             f"{'evals':>12} {'cap_n':>7} {'cap_g':>6} {'shift':>10}"]
    elide = len(rows) > max_rows
    if elide:
        head = rows[:max_rows // 2]
        tail = rows[-(max_rows - len(head)):]
        rows = head + [None] + tail
    n = max(float(n_points), 1.0)
    last = ring.shape[0] - 1
    for i in rows:
        if i is None:
            lines.append(f"{'...':>5}")
            continue
        r = ring[i]
        tag = "fin" if i == last else f"{i + 1}"
        lines.append(
            f"{tag:>5} {int(r[COL_N_CAND]):>9} "
            f"{100.0 * r[COL_N_CAND] / n:>6.1f}% {int(r[COL_GMAX]):>5} "
            f"{r[COL_EVALS]:>12.3g} {int(r[COL_CAP_N]):>7} "
            f"{int(r[COL_CAP_G]):>6} {r[COL_SHIFT]:>10.3g}")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# live drain: per-iteration listeners (ObsConfig.live_drain)
# --------------------------------------------------------------------------

_ring_listeners: list = []


def add_ring_listener(cb) -> None:
    """Register ``cb(iteration: int, row: np.ndarray)`` to receive each
    ring row as the fit's loop reads it home (fits running with
    ``ObsConfig(live_drain=True)``); the epilogue's row arrives with
    the drain at fit exit."""
    _ring_listeners.append(cb)


def remove_ring_listener(cb) -> None:
    try:
        _ring_listeners.remove(cb)
    except ValueError:
        pass


def emit_ring_row(iteration, row) -> None:
    """Hand one row to every listener. Listener exceptions are
    swallowed: a broken consumer must never kill a fit."""
    it = int(iteration)
    row = np.asarray(row)
    for cb in list(_ring_listeners):
        try:
            cb(it, row)
        except Exception:
            pass
