"""Borja frictional family (Matsuoka-Nakai / Lade-Duncan) tests.

Oracle: independent float64 NumPy implementation of the same monolithic
return mapping (the reference's own development pattern:
scripts/Borja-Constitutive-Models/Frictional-Monolithic-NR.c)."""

import numpy as np
import jax.numpy as jnp
import pytest

from nlpartsol.models.borja import borja_frictional
from nlpartsol.models import hyperelastic

E_, NU = 1e8, 0.3
PARAMS = dict(
    E=jnp.float32(E_),
    nu=jnp.float32(NU),
    m=jnp.float32(0.0),
    c0=jnp.float32(0.0),
    phi=jnp.float32(30.0),
    psi=jnp.float32(30.0),
    a1=jnp.float32(20000.0),
    a2=jnp.float32(0.0),
    a3=jnp.float32(2000.0),
    alpha=jnp.float32(1.0),
    cohesion=jnp.float32(0.0),
)


def _np_oracle(kind, Eh_tr, Lam_n, kap_n, n_iter=200):
    """float64 monolithic NR on z=(T,κ,Δλ) for isotropic-compression-safe
    states (simple full-step Newton)."""
    E, nu = E_, NU
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    G = E / (2 * (1 + nu))
    AA = lam * np.ones((3, 3)) + 2 * G * np.eye(3)
    CC = (1 / E) * np.eye(3) + (-nu / E) * (np.ones((3, 3)) - np.eye(3))
    a0, a1_, a2_ = 20000.0, 0.0, 2000.0
    alpha = 1.0
    K0 = 9.0 if kind == "matsuoka-nakai" else 27.0

    def inv(T):
        return T.sum(), T[0] * T[1] + T[1] * T[2] + T[0] * T[2], T[0] * T[1] * T[2]

    def F(T, kap):
        I1, I2, I3 = inv(T)
        if kind == "matsuoka-nakai":
            return np.cbrt((K0 + kap) * I3) - np.cbrt(I1 * I2)
        return np.cbrt((K0 + kap) * I3) - I1

    def dG(T, kpsi):
        I1, I2, I3 = inv(T)
        if kind == "matsuoka-nakai":
            gf = (I1 * (I1 - T) + I2) / (3 * np.cbrt(I1 * I2) ** 2)
            return np.cbrt((K0 + kpsi) * I3) / (3 * T) - gf
        return np.cbrt((K0 + kpsi) * I3) / (3 * T) - 1.0

    T = AA @ Eh_tr
    kap = kap_n
    dlam = 0.0
    F0 = F(T, kap)
    if F0 <= 1e-5:
        return T, kap, Lam_n, False
    for _ in range(n_iter):
        Lam = Lam_n + dlam
        I1 = T.sum()
        kap_hat = a0 * Lam * np.exp(a1_ * I1) * np.exp(-a2_ * Lam)
        R = np.concatenate(
            [CC @ T - Eh_tr + dlam * dG(T, alpha * kap), [kap - kap_hat], [F(T, kap)]]
        )
        if np.linalg.norm(R) < 1e-12:
            break
        # numerical jacobian (oracle: finite differences are fine)
        J = np.zeros((5, 5))
        z = np.concatenate([T, [kap], [dlam]])

        def res(zv):
            Tv, kapv, dlv = zv[:3], zv[3], zv[4]
            Lamv = Lam_n + dlv
            I1v = Tv.sum()
            kh = a0 * Lamv * np.exp(a1_ * I1v) * np.exp(-a2_ * Lamv)
            return np.concatenate(
                [CC @ Tv - Eh_tr + dlv * dG(Tv, alpha * kapv), [kapv - kh], [F(Tv, kapv)]]
            )

        h = 1e-7
        for j in range(5):
            zp = z.copy()
            zp[j] += h * max(1.0, abs(z[j]))
            J[:, j] = (res(zp) - R) / (h * max(1.0, abs(z[j])))
        dz = np.linalg.solve(J, R)
        # backtracking
        best, bd = None, np.inf
        for delta in (1.0, 0.5, 0.25, 0.0625):
            zc = z - delta * dz
            if Lam_n + zc[4] < 0:
                continue
            nr = np.linalg.norm(res(zc))
            if nr < bd:
                best, bd = zc, nr
        z = best
        T, kap, dlam = z[:3], z[3], z[4]
    return T, kap, Lam_n + dlam, True


@pytest.mark.parametrize("kind", ["matsuoka-nakai", "lade-duncan"])
def test_borja_elastic_branch(kind):
    """Strong isotropic compression below yield stays elastic = Hencky."""
    n, d = 6, 3
    DF = jnp.broadcast_to(
        jnp.asarray(np.diag([0.999, 0.999, 0.999]), jnp.float32), (n, d, d)
    )
    out = borja_frictional(
        jnp.zeros((n, d, d), jnp.float32),
        jnp.zeros((n,), jnp.float32),
        DF,
        jnp.zeros((n,), jnp.float32),
        jnp.full((n,), 50.0, jnp.float32),  # large kappa: yield far away
        yield_kind=kind,
        **PARAMS,
    )
    tau_ref, _, _ = hyperelastic.hencky(DF, jnp.float32(E_), jnp.float32(NU))
    np.testing.assert_allclose(
        np.asarray(out.tau), np.asarray(tau_ref), rtol=2e-3, atol=100.0
    )
    np.testing.assert_allclose(np.asarray(out.eps), 0.0, atol=1e-8)


@pytest.mark.parametrize("kind", ["matsuoka-nakai", "lade-duncan"])
def test_borja_plastic_matches_numpy_oracle(kind):
    """Sheared compressive state beyond yield: the 5x5 Newton must land on
    the same root as the float64 finite-difference oracle."""
    # trial Hencky strains: compressive with deviatoric shear
    Eh_tr = np.array([-0.004, -0.0015, -0.001])
    kap_n, Lam_n = 0.0, 0.0
    T_ref, kap_ref, Lam_ref, was_plastic = _np_oracle(kind, Eh_tr, Lam_n, kap_n)
    assert was_plastic, "oracle state must be plastic for this test"

    # feed the same trial state through the batched kernel: build bemi so
    # that trial_bemi reproduces Eh_tr with DF = I
    wm1 = np.expm1(2.0 * Eh_tr)
    bemi = np.diag(wm1[:3]).astype(np.float32)[None]
    out = borja_frictional(
        jnp.asarray(bemi),
        jnp.zeros((1,), jnp.float32),
        jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (1, 3, 3)),
        jnp.full((1,), Lam_n, jnp.float32),
        jnp.full((1,), kap_n, jnp.float32),
        yield_kind=kind,
        **PARAMS,
    )
    # principal Kirchhoff stresses (diagonal since eigvecs are identity here)
    T_got = np.sort(np.diag(np.asarray(out.tau)[0]))
    T_exp = np.sort(T_ref)
    np.testing.assert_allclose(T_got, T_exp, rtol=5e-3, atol=abs(T_exp).max() * 5e-3)
    assert float(out.eps[0]) > 0
    np.testing.assert_allclose(float(out.eps[0]), Lam_ref, rtol=2e-2, atol=1e-6)
    np.testing.assert_allclose(float(out.kappa[0]), kap_ref, rtol=2e-2, atol=1e-3)


@pytest.mark.parametrize("kind", ["matsuoka-nakai", "lade-duncan"])
def test_borja_yield_consistency(kind):
    """Plastic return must end on the hardened yield surface F ≈ 0."""
    Eh_tr = np.array([-0.005, -0.002, -0.0008])
    wm1 = np.expm1(2.0 * Eh_tr)
    bemi = np.diag(wm1).astype(np.float32)[None]
    out = borja_frictional(
        jnp.asarray(bemi),
        jnp.zeros((1,), jnp.float32),
        jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (1, 3, 3)),
        jnp.zeros((1,), jnp.float32),
        jnp.zeros((1,), jnp.float32),
        yield_kind=kind,
        **PARAMS,
    )
    assert float(out.eps[0]) > 0
    T = np.linalg.eigvalsh(np.asarray(out.tau)[0].astype(np.float64))
    I1 = T.sum()
    I2 = T[0] * T[1] + T[1] * T[2] + T[0] * T[2]
    I3 = np.prod(T)
    kap = float(out.kappa[0])
    K0 = 9.0 if kind == "matsuoka-nakai" else 27.0
    if kind == "matsuoka-nakai":
        f = np.cbrt((K0 + kap) * I3) - np.cbrt(I1 * I2)
    else:
        f = np.cbrt((K0 + kap) * I3) - I1
    assert abs(f) < 5e-2 * abs(I1), f"not on yield surface: F={f}, I1={I1}"
