"""Host reads of a device value a fit (``EngineStats.host_syncs``: the
group table, one read of the exit scalars an iteration), the mean over
the window's fits. Each is a point where the host waits for the card."""


def read(run):
    if not run.fits:
        return None
    return sum(f.host_syncs for f in run.fits) / len(run.fits)
