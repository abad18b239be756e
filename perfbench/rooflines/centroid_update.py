"""``repro_torch.kernels.centroid_update``: the per-cluster sums of a
move over all N points. A launch reads the points and their labels and
writes K sums of D and K counts. Only the launches inside the move are
counted: the groups' construction at the start of a fit sums the K
centroids, another shape."""

KERNELS = r"\b(cu_partial|cu_reduce)\b"
LAUNCH = r"\bcu_reduce\b"
RANGE = "kpynq/move_and_bounds"


def launch_bytes(config: dict) -> int:
    n, d, k = (config[key] for key in ("n_points", "n_dims", "k"))
    return n * d * 4 + n * 4 + k * (d + 1) * 4
