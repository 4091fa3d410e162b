"""Constitutive model tests vs independent NumPy float64 oracles
(the reference's own verification pattern: tests/Constitutive/*.py drive the
C kernels against einsum references, SURVEY.md §4)."""

import numpy as np
import jax.numpy as jnp
import pytest

from nlpartsol.models import hyperelastic, materials as M
from nlpartsol.models.vonmises import von_mises
from nlpartsol.models.druckerprager import drucker_prager, cone_parameters
from nlpartsol.models.dispatch import stress_integration

E_, NU = 1e7, 0.3
LAM = E_ * NU / ((1 + NU) * (1 - 2 * NU))
G_ = E_ / (2 * (1 + NU))
K_ = E_ / (3 * (1 - 2 * NU))


def rand_F(rng, n, d, scale=0.05):
    return (np.eye(d) + scale * rng.standard_normal((n, d, d))).astype(np.float32)


@pytest.mark.parametrize("d", [2, 3])
def test_neo_hookean_oracle(d):
    rng = np.random.default_rng(0)
    F = rand_F(rng, 16, d)
    tau, tau_zz, W = hyperelastic.neo_hookean(
        jnp.asarray(F), jnp.float32(E_), jnp.float32(NU)
    )
    F64 = F.astype(np.float64)
    J = np.linalg.det(F64)
    b = F64 @ F64.transpose(0, 2, 1)
    ref = 0.5 * LAM * (J**2 - 1)[:, None, None] * np.eye(d) + G_ * (b - np.eye(d))
    np.testing.assert_allclose(np.asarray(tau), ref, rtol=1e-4, atol=5.0)
    np.testing.assert_allclose(np.asarray(tau_zz), 0.5 * LAM * (J**2 - 1), rtol=1e-4, atol=1e-1)


@pytest.mark.parametrize("d", [2, 3])
def test_svk_oracle(d):
    rng = np.random.default_rng(1)
    F = rand_F(rng, 16, d)
    tau, tau_zz, W = hyperelastic.saint_venant_kirchhoff(
        jnp.asarray(F), jnp.float32(E_), jnp.float32(NU)
    )
    F64 = F.astype(np.float64)
    Egr = 0.5 * (F64.transpose(0, 2, 1) @ F64 - np.eye(d))
    S = LAM * np.trace(Egr, axis1=1, axis2=2)[:, None, None] * np.eye(d) + 2 * G_ * Egr
    ref = F64 @ S @ F64.transpose(0, 2, 1)
    np.testing.assert_allclose(np.asarray(tau), ref, rtol=1e-4, atol=5.0)


def test_hencky_small_strain_limit():
    """For infinitesimal strains Hencky ≈ linear elasticity."""
    rng = np.random.default_rng(2)
    d = 3
    F = rand_F(rng, 16, d, scale=1e-4)
    tau_h, _, _ = hyperelastic.hencky(jnp.asarray(F), jnp.float32(E_), jnp.float32(NU))
    tau_l, _, _ = hyperelastic.linear_elastic(jnp.asarray(F), jnp.float32(E_), jnp.float32(NU))
    np.testing.assert_allclose(np.asarray(tau_h), np.asarray(tau_l), rtol=5e-2, atol=2.0)


def _vm_oracle_uniaxial(be, DF, eps_n, sigma_y, H):
    """NumPy float64 J2 radial return with linear isotropic hardening."""
    be_tr = DF @ be @ DF.T
    w, V = np.linalg.eigh(be_tr)
    Eh = 0.5 * np.log(w)
    trE = Eh.sum()
    T_vol = K_ * trE * np.ones(3)
    T_dev = 2 * G_ * (Eh - trE / 3.0)
    J2 = np.linalg.norm(T_dev)
    s23 = np.sqrt(2.0 / 3.0)
    phi = J2 - s23 * (sigma_y + H * eps_n)
    if phi <= 0:
        return V @ np.diag(T_vol + T_dev) @ V.T, eps_n
    n = T_dev / J2
    # linear hardening closed form: J2 - s23*(sy+H*(eps_n+s23*dg)) - 2G dg = 0
    dg = phi / (2 * G_ + s23 * H * s23)
    eps_k = eps_n + s23 * dg
    T = T_vol + T_dev - 2 * G_ * dg * n
    return V @ np.diag(T) @ V.T, eps_k


def test_von_mises_oracle_3d():
    rng = np.random.default_rng(3)
    n = 12
    d = 3
    DF = rand_F(rng, n, d, scale=0.01)
    be = np.broadcast_to(np.eye(d, dtype=np.float32), (n, d, d)).copy()
    sigma_y, H = 2e4, 1e5
    out = von_mises(
        jnp.zeros((n, d, d), jnp.float32),
        jnp.zeros((n,), jnp.float32),
        jnp.asarray(DF),
        jnp.zeros((n,), jnp.float32),
        jnp.zeros((n, 3), jnp.float32),
        E=jnp.float32(E_),
        nu=jnp.float32(NU),
        sigma_y=jnp.float32(sigma_y),
        H=jnp.float32(H),
        theta=jnp.float32(1.0),
        K0=jnp.float32(0.0),
        Kinf=jnp.float32(0.0),
        delta=jnp.float32(0.0),
    )
    for i in range(n):
        ref_tau, ref_eps = _vm_oracle_uniaxial(
            be[i].astype(np.float64), DF[i].astype(np.float64), 0.0, sigma_y, H
        )
        np.testing.assert_allclose(np.asarray(out.tau)[i], ref_tau, rtol=2e-3, atol=30.0)
        np.testing.assert_allclose(np.asarray(out.eps)[i], ref_eps, rtol=2e-3, atol=1e-6)
    # plastic particles must exist in this sample for the test to mean much
    assert np.asarray(out.eps).max() > 0


def test_von_mises_plane_strain_zz():
    """2D plane strain tracks the zz channel: uniaxial in-plane stretch with
    yield produces out-of-plane plastic flow (be_zz ≠ 1)."""
    DF = jnp.asarray(np.array([[[1.01, 0.0], [0.0, 1.0]]], np.float32))
    out = von_mises(
        jnp.zeros((1, 2, 2), jnp.float32),
        jnp.zeros((1,), jnp.float32),
        DF,
        jnp.zeros((1,), jnp.float32),
        jnp.zeros((1, 3), jnp.float32),
        E=jnp.float32(E_),
        nu=jnp.float32(NU),
        sigma_y=jnp.float32(1e4),
        H=jnp.float32(0.0),
        theta=jnp.float32(1.0),
        K0=jnp.float32(0.0),
        Kinf=jnp.float32(0.0),
        delta=jnp.float32(0.0),
    )
    assert float(out.eps[0]) > 0  # yielded
    assert abs(float(out.bemi_zz[0])) > 1e-6  # zz plastic flow happened


def test_drucker_prager_elastic_matches_hencky():
    """Below yield DP returns the Hencky elastic stress."""
    rng = np.random.default_rng(4)
    n, d = 8, 3
    DF = rand_F(rng, n, d, scale=1e-4)
    be = np.broadcast_to(np.eye(d, dtype=np.float32), (n, d, d)).copy()
    kw = dict(
        E=jnp.float32(E_),
        nu=jnp.float32(NU),
        kappa0=jnp.float32(1e9),  # huge strength: stays elastic
        friction_angle=jnp.float32(30.0),
        dilatancy_angle=jnp.float32(30.0),
        exponent_ortiz=jnp.float32(2.0),
        plastic_strain_0=jnp.float32(1e-3),
        cohesion=jnp.float32(0.0),
        J2_degradated=jnp.float32(0.0),
    )
    out = drucker_prager(
        jnp.zeros((n, d, d), jnp.float32),
        jnp.zeros((n,), jnp.float32),
        jnp.asarray(DF),
        jnp.zeros((n,), jnp.float32),
        jnp.full((n,), 1e9, jnp.float32),
        **kw,
    )
    tau_ref, _, _ = hyperelastic.hencky(jnp.asarray(DF), jnp.float32(E_), jnp.float32(NU))
    np.testing.assert_allclose(np.asarray(out.tau), np.asarray(tau_ref), rtol=1e-3, atol=5.0)
    assert not np.any(np.asarray(out.eps) > 0)


def test_drucker_prager_yield_consistency():
    """A plastically-returning state must end on the (hardened) yield surface:
    Φ(T_ppal, κ_k) ≈ 0 for classical-region returns."""
    d = 3
    # strong deviatoric shear, compressive
    DF = np.eye(d, dtype=np.float32)
    DF[0, 1] = 0.05
    DF[0, 0] = 0.98
    DF = DF[None]
    kappa0 = 1e4
    out = drucker_prager(
        jnp.zeros((1, d, d), jnp.float32),
        jnp.zeros((1,), jnp.float32),
        jnp.asarray(DF),
        jnp.zeros((1,), jnp.float32),
        jnp.full((1,), kappa0, jnp.float32),
        E=jnp.float32(E_),
        nu=jnp.float32(NU),
        kappa0=jnp.float32(kappa0),
        friction_angle=jnp.float32(20.0),
        dilatancy_angle=jnp.float32(20.0),
        exponent_ortiz=jnp.float32(2.0),
        plastic_strain_0=jnp.float32(1e-3),
        cohesion=jnp.float32(0.0),
        J2_degradated=jnp.float32(0.0),
    )
    assert float(out.eps[0]) > 0, "expected plastic step"
    # Recompute Φ from the returned principal stress
    alpha_F, alpha_Q, beta = (
        float(x) for x in cone_parameters(jnp.float32(20.0), jnp.float32(20.0), d)
    )
    w, _ = np.linalg.eigh(np.asarray(out.tau)[0].astype(np.float64))
    p = w.sum() / 3.0
    dev = w - p
    J2 = np.linalg.norm(dev)
    phi = J2 - 3 * alpha_F * (-p) - beta * float(out.kappa[0])
    assert abs(phi) < 1e-2 * (J2 + 1.0), f"not on yield surface: phi={phi}"


def test_dispatch_mixed_materials():
    mats = M.material_table(
        [
            M.material(kind="Neo-Hookean-Wriggers", E=E_, nu=NU),
            M.material(kind="Von-Mises", E=E_, nu=NU, kappa0=1e4),
        ]
    )
    rng = np.random.default_rng(5)
    n, d = 10, 2
    F = rand_F(rng, n, d, scale=0.02)
    DF = F  # starting from identity
    mat_id = jnp.asarray(rng.integers(0, 2, n), jnp.int32)
    out = stress_integration(
        F_n1=jnp.asarray(F),
        DF=jnp.asarray(DF),
        dFdt_n1=jnp.zeros((n, d, d), jnp.float32),
        bemi=jnp.zeros((n, d, d), jnp.float32),
        bemi_zz=jnp.zeros((n,), jnp.float32),
        eps=jnp.zeros((n,), jnp.float32),
        kappa=jnp.zeros((n,), jnp.float32),
        back_stress=jnp.zeros((n, 3), jnp.float32),
        mat_id=mat_id,
        mats=mats,
        kinds=mats.kinds_present(),
    )
    # Neo-Hookean rows match the standalone model
    tau_nh, _, _ = hyperelastic.neo_hookean(jnp.asarray(F), jnp.float32(E_), jnp.float32(NU))
    sel = np.asarray(mat_id) == 0
    np.testing.assert_allclose(
        np.asarray(out.tau)[sel], np.asarray(tau_nh)[sel], rtol=1e-5
    )
    assert np.all(np.isfinite(np.asarray(out.tau)))


def test_mooney_rivlin_stress_is_energy_consistent():
    """tau must equal (dW/dF)Fᵀ for the energy the reference stub names
    (Mooney-Rivlin.c:17-40; its commented stress drops the 1/I3 factors its
    own energy implies — AD adjudicates for the energy-consistent form)."""
    import jax

    rng = np.random.default_rng(5)
    E_, nu, mu1, mu2 = 1e6, 0.3, 4e5, 1e5
    args = tuple(jnp.float64(v) for v in (E_, nu, mu1, mu2))
    F = jnp.asarray(
        np.eye(3) + 0.1 * rng.standard_normal((4, 3, 3)), jnp.float64
    )

    tau, tau_zz, W = hyperelastic.mooney_rivlin(F, *args)
    # undeformed: zero stress, zero energy
    tau0, tzz0, W0 = hyperelastic.mooney_rivlin(
        jnp.broadcast_to(jnp.eye(3, dtype=jnp.float64), (1, 3, 3)), *args
    )
    np.testing.assert_allclose(np.asarray(tau0), 0.0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(W0), 0.0, atol=1e-12)
    assert float(tzz0[0]) == pytest.approx(0.0, abs=1e-9)

    dWdF = jax.vmap(
        jax.grad(lambda f: hyperelastic.mooney_rivlin(f[None], *args)[2][0])
    )(F)
    tau_ad = np.einsum("pij,pkj->pik", np.asarray(dWdF), np.asarray(F))
    # f32 session (x64 is only enabled in test_reference_golden)
    np.testing.assert_allclose(np.asarray(tau), tau_ad, rtol=2e-5, atol=1.0)

    # plane strain == 3D with F_zz = 1 (in-plane block and zz channel)
    F2 = F[:, :2, :2].at[:, 0, 1].set(0.0)  # keep invertibility simple
    F3 = jnp.zeros((4, 3, 3), jnp.float64)
    F3 = F3.at[:, :2, :2].set(F2).at[:, 2, 2].set(1.0)
    t2, tzz2, W2 = hyperelastic.mooney_rivlin(F2, *args)
    t3, _, W3 = hyperelastic.mooney_rivlin(F3, *args)
    np.testing.assert_allclose(
        np.asarray(t2), np.asarray(t3)[:, :2, :2], rtol=1e-5, atol=1.0
    )
    np.testing.assert_allclose(
        np.asarray(tzz2), np.asarray(t3)[:, 2, 2], rtol=1e-5, atol=1.0
    )
    np.testing.assert_allclose(np.asarray(W2), np.asarray(W3), rtol=1e-5, atol=1.0)


def test_bingham_reduces_to_newtonian_and_yield_limit():
    from nlpartsol.models.fluid import bingham_fluid, newtonian_fluid

    rng = np.random.default_rng(6)
    F = jnp.asarray(np.eye(3) + 0.05 * rng.standard_normal((3, 3, 3)), jnp.float64)
    dFdt = jnp.asarray(0.5 * rng.standard_normal((3, 3, 3)), jnp.float64)
    common = dict(p0=jnp.float64(10.0), n=jnp.float64(7.0), K=jnp.float64(2e5))
    # tau_y = 0: exact Newtonian reduction in 3D (2/Ndim == 2/3)
    tb, tbz, _ = bingham_fluid(
        F, dFdt, mu0=jnp.float64(0.3), tau_y=jnp.float64(0.0),
        m_pap=jnp.float64(100.0), **common
    )
    tn_, tnz, _ = newtonian_fluid(F, dFdt, mu=jnp.float64(0.3), **common)
    np.testing.assert_allclose(np.asarray(tb), np.asarray(tn_), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(tbz), np.asarray(tnz), rtol=1e-12)

    # simple shear at rate g: tau_xy -> mu0*g + tau_y for m*g >> 1
    # (Papanastasiou-regularised Bingham law, Bingham-Fluid.c:91-99)
    g = 2.0
    F1 = jnp.eye(3, dtype=jnp.float64)[None]
    dF1 = jnp.zeros((1, 3, 3), jnp.float64).at[0, 0, 1].set(g)
    tau_y, mu0 = 5.0, 0.3
    tb, _, _ = bingham_fluid(
        F1, dF1, mu0=jnp.float64(mu0), tau_y=jnp.float64(tau_y),
        m_pap=jnp.float64(50.0), p0=jnp.float64(0.0), n=jnp.float64(7.0),
        K=jnp.float64(0.0),
    )
    assert float(tb[0, 0, 1]) == pytest.approx(mu0 * g + tau_y, rel=1e-6)


def test_modified_lade_duncan_reduces_to_lade_duncan_at_m0():
    """MLD with m=0 is exactly Lade-Duncan (harness eval_K1: the (pa/I1)^m
    factor degenerates to 1, Frictional-Monolithic.c:659-667)."""
    from nlpartsol.models.borja import borja_frictional

    Eh_tr = np.array([-0.004, -0.0015, -0.001])
    wm1 = np.expm1(2.0 * Eh_tr)
    bemi = jnp.asarray(np.diag(wm1)[None], jnp.float64)
    kw = dict(
        E=jnp.float64(1e8), nu=jnp.float64(0.3), c0=jnp.float64(0.0),
        phi=jnp.float64(30.0), psi=jnp.float64(30.0), a1=jnp.float64(20000.0),
        a2=jnp.float64(0.0), a3=jnp.float64(2000.0), alpha=jnp.float64(1.0),
        cohesion=jnp.float64(0.0),
    )
    args = (
        bemi, jnp.zeros((1,), jnp.float64),
        jnp.broadcast_to(jnp.eye(3, dtype=jnp.float64), (1, 3, 3)),
        jnp.zeros((1,), jnp.float64), jnp.zeros((1,), jnp.float64),
    )
    out_mld = borja_frictional(
        *args, yield_kind="modified-lade-duncan",
        m=jnp.float64(0.0), pa=jnp.float64(-100.0), **kw
    )
    out_ld = borja_frictional(
        *args, yield_kind="lade-duncan", m=jnp.float64(0.0), **kw
    )
    assert float(out_mld.eps[0]) > 0  # actually plastic
    # f32 session: the two branches differ only by (pa/I1)^0 == 1 factors,
    # whose evaluation order perturbs the Newton path at ~1e-6 relative
    np.testing.assert_allclose(
        np.asarray(out_mld.tau), np.asarray(out_ld.tau), rtol=1e-5, atol=10.0
    )
    np.testing.assert_allclose(
        float(out_mld.kappa[0]), float(out_ld.kappa[0]), rtol=1e-5, atol=1e-4
    )


def test_dispatch_includes_new_kinds():
    """Bingham / Mooney-Rivlin / Modified-Lade-Duncan reachable through
    stress_integration + the deck material-name map."""
    from nlpartsol.models import dispatch as con
    from nlpartsol.io.builder import _MODEL_NAMES

    for name in ("Bingham-Fluid", "Mooney-Rivlin", "Modified-Lade-Duncan"):
        assert name in _MODEL_NAMES or name in M.KIND_NAMES

    rows = [
        M.material(kind="Mooney-Rivlin", E=1e6, nu=0.3, mu1_mr=4e5, mu2_mr=1e5),
        M.material(kind="Bingham-Fluid", kappa0=5.0, viscosity=0.3,
                   fluidity_param=50.0, compressibility=2e5, n_macdonald=7.0),
        M.material(kind="Modified-Lade-Duncan", E=1e8, nu=0.3,
                   m_frictional=0.2, atmospheric_pressure=-100.0,
                   a1_borja=20000.0, a2_borja=0.005, a3_borja=35.0,
                   alpha_borja=0.5),
    ]
    mats = M.material_table(rows)
    n = 3
    rng = np.random.default_rng(7)
    F = jnp.asarray(np.eye(3) + 0.02 * rng.standard_normal((n, 3, 3)), jnp.float64)
    DF = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float64), (n, 3, 3))
    out = con.stress_integration(
        F_n1=F, DF=DF, dFdt_n1=0.1 * F,
        bemi=jnp.zeros((n, 3, 3), jnp.float64), bemi_zz=jnp.zeros((n,)),
        eps=jnp.zeros((n,)), kappa=jnp.zeros((n,)),
        back_stress=jnp.zeros((n, 3)), mat_id=jnp.arange(n, dtype=jnp.int32),
        mats=mats, kinds=mats.kinds_present(),
    )
    assert np.all(np.isfinite(np.asarray(out.tau)))
    assert np.any(np.asarray(out.tau) != 0.0)
