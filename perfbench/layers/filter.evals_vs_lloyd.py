"""The filter's work against Lloyd's: the fit's exact distance count
(``KMeansResult.distance_evals``) over N * K * n_iters, the mean over the
window's fits. The paper's work efficiency: lower is less work."""


def read(run):
    n, k = run.config["n_points"], run.config["k"]
    fits = [f for f in run.fits if f.n_iters > 0]
    if not fits:
        return None
    return sum(f.distance_evals / (n * k * f.n_iters) for f in fits) \
        / len(fits)
