"""Shared spectral machinery for the principal-space plasticity models.

The reference's Von-Mises / Drucker-Prager / Borja models all follow the same
skeleton (SURVEY.md §2.6): trial elastic left Cauchy-Green
b_e^tr = ΔF · b_e · ΔFᵀ, eigendecomposition (LAPACK ``dsyev`` in
__compute_trial_b_e, Von-Mises.c:404-470), return mapping on the three
principal Hencky strains, then reconstruction of stress and corrected b_e
from the (unchanged) trial eigenvectors.  In plane strain the third
principal value is the stored zz channel (``b_e[4]``, Von-Mises.c:468) with
a trivial out-of-plane eigenvector.

Difference from the reference: the state is stored as the *deviation* b_e − I
(``Particles.bemi``), zero at rest, so that in float32 the principal Hencky
strains come out of ``log1p`` on exactly-computed deviations instead of
``log`` on eigenvalues that have already lost their small-strain content:
  b_e^tr − I = ΔF (b_e − I) ΔFᵀ + (ΔF ΔFᵀ − I)
with the last term expanded cancellation-free from ΔA = ΔF − I.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops import tensor as tn


def trial_bemi(bemi: jax.Array, bemi_zz: jax.Array, DF: jax.Array):
    """Spectrum of the trial elastic b, in deviation form.

    Args:
      bemi: (..., d, d) b_e − I at t=n.
      bemi_zz: (...,) out-of-plane b_e − 1 (plane strain; ignored for d=3).
      DF: (..., d, d) incremental deformation gradient.

    Returns:
      wm1: (..., 3) principal values of (b_e^tr − I); index 2 = zz for d=2.
      V:   (..., d, d) in-plane eigenvectors (columns).
    """
    d = bemi.shape[-1]
    dA = DF - jnp.eye(d, dtype=DF.dtype)
    bemi_tr = tn.bmm_t(tn.bmm(DF, bemi), DF) + tn.bmi_from_disp_grad(dA)
    wm1, V = tn.sym_eig(bemi_tr)
    if d == 2:
        wm1 = jnp.concatenate([wm1, bemi_zz[..., None]], axis=-1)
    return wm1, V


def hencky_from_wm1(wm1: jax.Array) -> jax.Array:
    """Principal Hencky strains E_h = ½ ln(w) = ½ log1p(w − 1)."""
    return 0.5 * jnp.log1p(jnp.maximum(wm1, -1.0 + 1e-12))


def wm1_from_hencky(Eh: jax.Array) -> jax.Array:
    """w − 1 = expm1(2 E_h) (the corrector's inverse map)."""
    return jnp.expm1(2.0 * Eh)


def rebuild(vals3: jax.Array, V: jax.Array):
    """Reassemble a symmetric tensor from 3 principal values and the trial
    eigenvectors.  Because Σ_A v_A v_Aᵀ = I, feeding principal *deviations*
    returns the tensor's deviation from identity — so this one function
    serves both the stress (absolute) and bemi (deviation) reconstructions.

    Returns ((..., d, d) in-plane part, (...,) zz value)."""
    d = V.shape[-1]
    inplane = tn.sym_from_eig(vals3[..., :d], V)
    zz = vals3[..., 2]
    return inplane, zz
