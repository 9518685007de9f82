"""K4's order of operations (``ops/eig.py: mgs_qr_panel_plain``: two MGS
passes with the columns in panels of 32, the Gram-row coefficient inside a
panel) against the plain version and against JAX's ``mgs_qr_pallas``, in
float64 on the CPU.  JAX runs a Householder QR in interpret mode, so it is
compared up to column signs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_slod_tpu.ops import eig as jax_eig
from dealii_slod_tpu_torch.ops import eig

torch.set_num_threads(2)

# the chain's shapes (125, 32), the float64 shapes (125, 124), (375, 374),
# ragged last panels (k = 22, 33, 124, n) and a single-column last panel
SHAPES = [(125, 22), (125, 32), (125, 33), (125, 124), (125, 125),
          (375, 22), (375, 33), (375, 124), (375, 374), (375, 375)]


def _log_scaled(rng, B, n, k):
    """Columns scaled by logspace(0, -5): the subspace-iteration regime."""
    return rng.standard_normal((B, n, k)) * np.logspace(0, -5, k)


@pytest.mark.parametrize("n, k", SHAPES)
def test_mgs_panel_plain_matches_plain_and_jax(n, k):
    """At B = 2: within 1e-10 of ``mgs_qr_plain`` (the same MGS arithmetic
    in another order), orthonormal to 1e-12, and JAX's Householder Q up to
    column signs to 1e-10."""
    X = _log_scaled(np.random.default_rng(1000 * n + k), 2, n, k)
    Q = eig.mgs_qr_panel_plain(torch.from_numpy(X)).numpy()
    Qp = eig.mgs_qr_plain(torch.from_numpy(X)).numpy()
    assert np.abs(Q - Qp).max() / np.abs(Qp).max() <= 1e-10
    QtQ = np.einsum("bni,bnj->bij", Q, Q)
    assert np.abs(QtQ - np.eye(k)).max() <= 1e-12
    jQ = np.asarray(jax_eig.mgs_qr_pallas(jnp.asarray(X), interpret=True))
    sgn = np.sign((Q * jQ).sum(1, keepdims=True))
    assert np.abs(Q * sgn - jQ).max() <= 1e-10


@pytest.mark.parametrize("n, k", [(40, 8), (125, 124), (375, 374)])
def test_mgs_panel_plain_null_columns_stay_zero(n, k):
    """Null columns in the first panel, on a panel boundary and in the last
    panel come out exactly zero; the other columns stay orthonormal."""
    X = _log_scaled(np.random.default_rng(n + k), 2, n, k)
    null = sorted({3, min(32, k - 2), k - 1})
    X[:, :, null] = 0.0
    Q = eig.mgs_qr_panel_plain(torch.from_numpy(X)).numpy()
    assert np.all(Q[:, :, null] == 0.0)
    live = [c for c in range(k) if c not in null]
    QtQ = np.einsum("bni,bnj->bij", Q[:, :, live], Q[:, :, live])
    assert np.abs(QtQ - np.eye(len(live))).max() <= 1e-12


@pytest.mark.parametrize("n, k", [(40, 8), (125, 33)])
def test_mgs_panel_plain_with_unit_panels_is_plain(n, k):
    """With panels of one column the Gram row is |x_j|^2 alone and every
    later column receives q_j as x_i . q_j: ``mgs_qr_plain`` bit for bit."""
    X = torch.from_numpy(_log_scaled(np.random.default_rng(k), 3, n, k))
    assert torch.equal(eig.mgs_qr_panel_plain(X, panel=1),
                       eig.mgs_qr_plain(X))
