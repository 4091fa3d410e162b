"""Unstructured FEM background meshes (shapefun/femesh.py).

Unit oracles: partition of unity, linear completeness (Σ N_a x_a = x,
Σ ∇N_a ⊗ x_a = I, Σ ∇N_a = 0) on randomly distorted T3/Q4/T4/H8
elements — the properties the reference's isoparametric element modules
guarantee by construction (/root/reference/nl-partsol/src/Nodes/T3.c:100,
Q4.c:112, T4.c, H8.c).  End-to-end: the BASELINE config-1 elastic bar
vibration on a genuinely non-Cartesian T3 triangulation.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nlpartsol.shapefun import femesh
from nlpartsol.types import make_particles
from nlpartsol.models import materials as M
from nlpartsol.formulations.explicit import ExplicitConfig, run
from nlpartsol.formulations.courant import courant_dt, celerity


def _distorted_element(kind, rng):
    """One valid element with randomly perturbed corner coords."""
    if kind == "T3":
        base = np.array([[0, 0], [1, 0], [0, 1]], float)
    elif kind == "Q4":
        base = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], float)
    elif kind == "T4":
        base = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], float)
    else:  # H8
        base = femesh._H8_SIGNS * 0.5 + 0.5
    return base + rng.uniform(-0.12, 0.12, base.shape)


@pytest.mark.parametrize("kind", ["T3", "Q4", "T4", "H8"])
def test_isoparametric_identities(kind):
    rng = np.random.default_rng(3)
    xe = jnp.asarray(_distorted_element(kind, rng))
    d = xe.shape[1]
    # sample points strictly inside: convex combinations of the corners
    w = rng.dirichlet(np.ones(xe.shape[0]), size=32)
    x = jnp.asarray(w @ np.asarray(xe))
    xi = femesh.x_to_xi(kind, xe[None], x)
    assert bool(femesh.inside(kind, xi, tol=1e-4).all())
    N, dNdxi = femesh.shape_ref(kind, xi)
    # partition of unity and the isoparametric map round-trip
    np.testing.assert_allclose(np.asarray(N.sum(-1)), 1.0, atol=1e-5)
    x_rt = jnp.einsum("pa,ai->pi", N, xe)
    np.testing.assert_allclose(np.asarray(x_rt), np.asarray(x), atol=1e-5)
    # physical gradients: linear completeness
    J = jnp.einsum("ai,paj->pij", xe, dNdxi)
    dN = jnp.einsum("paj,pji->pai", dNdxi, jnp.linalg.inv(J))
    np.testing.assert_allclose(
        np.asarray(jnp.einsum("pai,aj->pij", dN, xe)),
        np.broadcast_to(np.eye(d), (32, d, d)),
        atol=1e-5,
    )
    np.testing.assert_allclose(np.asarray(dN.sum(1)), 0.0, atol=1e-5)


def _tri_bar(nx=24, ny=3, L=1.0, H=0.15, perturb=0.2, seed=0):
    """Non-Cartesian T3 triangulation of a bar with perturbed interior
    nodes + alternating diagonals."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(0, L, nx + 1)
    ys = np.linspace(0, H, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel()], -1)
    hx, hy = L / nx, H / ny
    interior = (
        (coords[:, 0] > 1e-9)
        & (coords[:, 0] < L - 1e-9)
        & (coords[:, 1] > 1e-9)
        & (coords[:, 1] < H - 1e-9)
    )
    coords[interior] += rng.uniform(-perturb, perturb, coords[interior].shape) * [hx, hy]
    ids = np.arange((nx + 1) * (ny + 1)).reshape(nx + 1, ny + 1)
    tris = []
    for i in range(nx):
        for j in range(ny):
            a, b, c, dd = ids[i, j], ids[i + 1, j], ids[i + 1, j + 1], ids[i, j + 1]
            if (i + j) % 2 == 0:
                tris += [[a, b, c], [a, c, dd]]
            else:
                tris += [[a, b, dd], [b, c, dd]]
    return coords, np.asarray(tris), ids


def test_locate_on_tri_mesh():
    coords, tris, _ = _tri_bar()
    mesh = femesh.build_femesh(coords, tris, "T3")
    rng = np.random.default_rng(7)
    # random points inside random elements (barycentric samples)
    e = rng.integers(0, len(tris), 200)
    w = rng.dirichlet(np.ones(3), size=200)
    pts = np.einsum("pa,pai->pi", w, coords[tris[e]])
    elem, xi, found = jax.jit(femesh.locate)(mesh, jnp.asarray(pts))
    assert bool(found.all())
    # the located element must actually contain the point (ties at shared
    # edges may pick a different element than `e` — verify geometrically)
    N, _ = femesh.shape_ref("T3", xi)
    assert float(N.min()) > -1e-5
    xr = jnp.einsum("pa,pai->pi", N, mesh.nodes[mesh.conn[elem]])
    np.testing.assert_allclose(np.asarray(xr), pts, atol=1e-5)
    # a point far outside reports not-found
    _, _, f2 = femesh.locate(mesh, jnp.asarray([[10.0, 10.0]]))
    assert not bool(f2[0])


def test_evaluate_partition_of_unity():
    coords, tris, _ = _tri_bar()
    mesh = femesh.build_femesh(coords, tris, "T3")
    rng = np.random.default_rng(1)
    e = rng.integers(0, len(tris), 100)
    w = rng.dirichlet(np.ones(3), size=100)
    pts = np.einsum("pa,pai->pi", w, coords[tris[e]])
    sf = femesh.evaluate(mesh, jnp.asarray(pts))
    np.testing.assert_allclose(np.asarray(sf["N"].sum(-1)), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(sf["dN"].sum(1)), 0.0, atol=1e-4)


E_, RHO = 1e7, 1000.0
C = celerity(E_, RHO)


def test_bar_vibration_unstructured_t3():
    """BASELINE config 1 on a non-Cartesian T3 mesh."""
    L, H = 1.0, 0.15
    coords, tris, ids = _tri_bar(nx=24, ny=3, L=L, H=H)
    n_nodes = len(coords)
    dmask = np.zeros((n_nodes, 2), bool)
    dmask[ids[0, :], 0] = True
    dmask[ids[-1, :], 0] = True
    dmask[:, 1] = True  # suppress transverse motion: 1D axial behavior
    mesh = femesh.build_femesh(coords, tris, "T3", dirichlet_mask=dmask)

    # particles: 3 per triangle at edge-midpoint barycenters, V = A/3
    xe = coords[tris]  # (Ne, 3, 2)
    bary = np.array([[0.5, 0.25, 0.25], [0.25, 0.5, 0.25], [0.25, 0.25, 0.5]])
    pts = np.einsum("ba,eai->ebi", bary, xe).reshape(-1, 2)
    e1, e2 = xe[:, 1] - xe[:, 0], xe[:, 2] - xe[:, 0]
    area = 0.5 * np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
    vol = np.repeat(area / 3.0, 3)
    p = make_particles(
        pts.astype(np.float32),
        mass=(RHO * vol).astype(np.float32),
        vol0=vol.astype(np.float32),
    )
    V = 0.01
    omega = np.pi * C / L
    vx = V * np.sin(np.pi * pts[:, 0] / L)
    p = p.replace(v=jnp.asarray(np.stack([vx, np.zeros_like(vx)], -1), jnp.float32))

    mats = M.material_table(
        [M.material(kind="Neo-Hookean-Wriggers", E=E_, nu=0.0, rho0=RHO)]
    )
    dt = courant_dt(0.2, mesh.spacing, C)
    cfg = ExplicitConfig(dt=dt, shapefun="fem", kinds=(M.NEO_HOOKEAN,), transfer="scatter")
    n_quarter = int(round((np.pi / 2 / omega) / dt))
    runj = jax.jit(run, static_argnums=(3, 4))
    p1, _ = runj(p, mesh, mats, cfg, n_quarter)

    u_ref = (V / omega) * np.sin(np.pi * pts[:, 0] / L)
    u_num = np.asarray(p1.dis)[:, 0]
    err = np.abs(u_num - u_ref).max() / (V / omega)
    assert err < 0.12, f"quarter-period displacement error {err:.3f}"


def _unstructured_bar_problem():
    L, H = 1.0, 0.15
    coords, tris, ids = _tri_bar(nx=24, ny=3, L=L, H=H)
    dmask = np.zeros((len(coords), 2), bool)
    dmask[ids[0, :], 0] = True
    dmask[ids[-1, :], 0] = True
    dmask[:, 1] = True
    mesh = femesh.build_femesh(coords, tris, "T3", dirichlet_mask=dmask)
    xe = coords[tris]
    bary = np.array([[0.5, 0.25, 0.25], [0.25, 0.5, 0.25], [0.25, 0.25, 0.5]])
    pts = np.einsum("ba,eai->ebi", bary, xe).reshape(-1, 2)
    e1, e2 = xe[:, 1] - xe[:, 0], xe[:, 2] - xe[:, 0]
    area = 0.5 * np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
    vol = np.repeat(area / 3.0, 3)
    p = make_particles(
        pts.astype(np.float32),
        mass=(RHO * vol).astype(np.float32),
        vol0=vol.astype(np.float32),
    )
    mats = M.material_table(
        [M.material(kind="Neo-Hookean-Wriggers", E=E_, nu=0.0, rho0=RHO)]
    )
    return mesh, p, pts, mats, L


def test_bar_vibration_unstructured_lme():
    """Meshfree LME over the unstructured node cloud — the reference's
    flagship configuration (GramsShapeFun Type=LME on a GiD mesh)."""
    from nlpartsol.shapefun import lme as lme_mod

    mesh, p, pts, mats, L = _unstructured_bar_problem()
    lp = lme_mod.LMEParams(gamma=3.0)
    mesh = femesh.with_node_bins(mesh, lme_mod.support_radius(lp, mesh.h_avg))
    V = 0.01
    omega = np.pi * C / L
    vx = V * np.sin(np.pi * pts[:, 0] / L)
    p = p.replace(v=jnp.asarray(np.stack([vx, np.zeros_like(vx)], -1), jnp.float32))
    dt = courant_dt(0.2, mesh.spacing, C)
    cfg = ExplicitConfig(
        dt=dt, shapefun="lme", lme_params=lp, kinds=(M.NEO_HOOKEAN,), transfer="scatter"
    )
    # PoU sanity on the meshfree basis first
    sf = femesh.evaluate_lme(mesh, p.x, p.lme_lambda, lp)
    np.testing.assert_allclose(np.asarray(sf["N"].sum(-1)), 1.0, atol=1e-4)
    np.testing.assert_allclose(np.asarray(sf["dN"].sum(1)), 0.0, atol=2e-2)
    n_quarter = int(round((np.pi / 2 / omega) / dt))
    runj = jax.jit(run, static_argnums=(3, 4))
    p1, _ = runj(p, mesh, mats, cfg, n_quarter)
    u_ref = (V / omega) * np.sin(np.pi * pts[:, 0] / L)
    err = np.abs(np.asarray(p1.dis)[:, 0] - u_ref).max() / (V / omega)
    assert err < 0.12, f"quarter-period displacement error {err:.3f}"


def test_implicit_unstructured_t3():
    """Implicit Newmark-β on the unstructured mesh (ScatterEngine path)."""
    from nlpartsol.formulations.implicit import ImplicitConfig, implicit_step

    mesh, p, pts, mats, L = _unstructured_bar_problem()
    V = 0.01
    vx = V * np.sin(np.pi * pts[:, 0] / L)
    p = p.replace(v=jnp.asarray(np.stack([vx, np.zeros_like(vx)], -1), jnp.float32))
    dt = courant_dt(1.0, mesh.spacing, C)  # implicit: larger step
    cfg = ImplicitConfig(
        dt=dt, shapefun="fem", kinds=(M.NEO_HOOKEAN,), transfer="scatter",
        newton_tol=1e-6, newton_maxiter=20,
    )
    stepj = jax.jit(implicit_step, static_argnums=(3,))
    body = jnp.zeros((2,), jnp.float32)
    for _ in range(3):
        p, diag = stepj(p, mesh, mats, cfg, body)
    assert bool(diag["converged"])
    assert np.isfinite(np.asarray(p.x)).all()
    assert float(jnp.abs(p.dis).max()) < 0.01  # small-amplitude regime
