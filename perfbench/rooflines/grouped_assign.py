"""``repro_torch.kernels.grouped_assign``: the candidate pass over all N
points (the kernel backend does not compact). A pass reads the points
and the centroids, writes each point's label and upper bound, and reads
and writes its G lower bounds.

Its arithmetic is a distance of 2·D operations (D fused multiply-adds)
for each pair of a point and a centroid that it scores. The fit reports
those pairs in ``distance_evals`` together with the N·K of the initial
assignment and, in each move, at most one own-distance a point; so the
traced passes scored at least ``distance_evals - N·K - N·n_iters`` pairs
a fit, which is what is counted: the least time is never overstated."""

KERNELS = r"\b(ga_kernel|ga_plan_kernel)\b"
LAUNCH = r"\bga_kernel\b"
RANGE = "kpynq/candidate_pass"


def launch_bytes(config: dict) -> int:
    n, d, k, g = (config[key] for key in ("n_points", "n_dims", "k",
                                           "n_groups"))
    return n * d * 4 + k * d * 4 + n * 8 + 2 * n * g * 4


def pass_pairs(config: dict, fit) -> int:
    """The fewest pairs the candidate passes of one fit scored."""
    n, k = config["n_points"], config["k"]
    return max(0, fit.distance_evals - n * k - n * fit.n_iters)


def traced_flops(reading) -> int:
    d = reading.config["n_dims"]
    return sum(2 * d * pass_pairs(reading.config, f)
               for f in reading.traced)
