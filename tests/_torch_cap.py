"""The reference's lower-bound cap, for the parity tests of whole fits.

After a candidate pass, JAX's engine caps the lower bound of a point's
old group at ``ub_t`` wherever the pass found ``best_d < ub_t``. The
port caps only where the point moved (``repro_torch.core.engine.
_left_at``). In exact arithmetic the two rules are the same. They part
where the best candidate is the point's own centroid and the pass's
product rounds its distance below the refresh's. The reference's
``distance_evals`` carries the work those caps add, at a rate that
depends on how its backend rounds (ROADMAP Queue 3 item 1).

So a parity test of a whole fit runs the port twice:
- under :func:`reference_cap`, with the reference's rule, held to JAX
  as before;
- as it is, held to that run by :func:`assert_same_fit_less_work`.
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.core import engine


def _reference_left_at(changed, new_assign, old_assign, ub_t):
    return torch.where(changed, ub_t, float("inf"))


@contextlib.contextmanager
def reference_cap():
    """The port with the reference's cap rule, for the ``with`` body."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine, "_left_at", _reference_left_at)
        yield


def assert_same_fit_less_work(r, r_ref):
    """``r`` (the port) and ``r_ref`` (the port under
    :func:`reference_cap`) are the same fit bit for bit: labels,
    ``n_iters``, centroids and inertia. ``r`` does no more distance
    evaluations."""
    np.testing.assert_array_equal(r.assignments.numpy(),
                                  r_ref.assignments.numpy())
    assert int(r.n_iters) == int(r_ref.n_iters)
    np.testing.assert_array_equal(r.centroids.numpy(),
                                  r_ref.centroids.numpy())
    assert float(r.inertia) == float(r_ref.inertia)
    assert int(r.distance_evals) <= int(r_ref.distance_evals)
