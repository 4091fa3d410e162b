"""3D fused LME transfers vs the XLA windowed engine (oracle).

Mirrors tests/test_pallas_transfer.py for the 3D path
(ops/pallas_transfer.py: the widened-window basis in plain XLA)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nlpartsol.types import Grid, make_particles
from nlpartsol.ops import pallas_transfer as pt
from nlpartsol.ops import windowed
from nlpartsol.shapefun import lme
from nlpartsol.formulations.explicit import to_slot_layout


def _problem3(seed=0, n_side=8, n_particles=60, gamma=5.0, tol_zero=1e-6):
    rng = np.random.default_rng(seed)
    h = 1.0 / (n_side - 1)
    grid = Grid(dims=(n_side,) * 3, spacing=h, origin=(0.0, 0.0, 0.0))
    x = rng.uniform(0.2, 0.8, size=(n_particles, 3)).astype(np.float32)
    p = make_particles(
        x,
        mass=rng.uniform(0.5, 2.0, n_particles).astype(np.float32),
        vol0=np.full(n_particles, h**3 / 8, np.float32),
    )
    probe = windowed.box_for_extent(grid, [0.15] * 3, [0.85] * 3, capacity=1, margin=1)
    cap = windowed.required_capacity(grid, probe, x)
    box = probe.replace(capacity=max(4, cap))
    p = to_slot_layout(p, grid, box)
    params = lme.LMEParams(gamma=gamma, tol_zero=tol_zero)
    return grid, box, p, params


def _oracle(grid, box, p, params):
    sf = lme.evaluate(grid, p.x, p.lme_lambda, params)
    offsets = lme.offsets_for(3, params)
    mask = sf["mask"] & p.active[:, None]
    return sf, offsets, mask


def _tr(p, box):
    C, nc = box.capacity, box.n_cells
    x_t = pt.to_channel_leading(p.x, C, nc)
    lam_t = pt.to_channel_leading(p.lme_lambda, C, nc)
    act_t = pt.to_channel_leading(p.active.astype(jnp.float32), C, nc)
    return x_t, lam_t, act_t


def test_scatter3_matches_windowed_p2g():
    grid, box, p, params = _problem3()
    sf, offsets, mask = _oracle(grid, box, p, params)
    N = jnp.where(mask, sf["N"], 0.0)
    rng = np.random.default_rng(1)
    vel = jnp.asarray(rng.standard_normal((p.count, 3)), jnp.float32)
    m_ref = windowed.p2g(N * p.mass[:, None], box, grid, offsets)
    mom = (N * p.mass[:, None])[..., None] * vel[:, None, :]
    mom_ref = windowed.p2g(mom, box, grid, offsets)

    x_t, lam_t, act_t = _tr(p, box)
    C, nc = box.capacity, box.n_cells
    chans = [p.mass] + [p.mass * vel[:, i] for i in range(3)]
    fN = jnp.stack([pt.to_channel_leading(c, C, nc)[0] for c in chans])
    nodes, lam_new, nnz = pt.fused_scatter(grid, box, params, x_t, lam_t, act_t, fN)
    np.testing.assert_allclose(np.asarray(nodes[:, 0]), np.asarray(m_ref),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(nodes[:, 1:]), np.asarray(mom_ref),
                               rtol=2e-5, atol=1e-6)
    sel = np.asarray(p.active)
    np.testing.assert_allclose(
        np.asarray(pt.from_channel_leading(lam_new))[sel],
        np.asarray(sf["lam"])[sel], rtol=1e-3, atol=1e-3 / grid.spacing * 1e-3,
    )


def test_scatter3_grad_weighted_matches_forces():
    grid, box, p, params = _problem3(seed=2)
    sf, offsets, mask = _oracle(grid, box, p, params)
    dN = jnp.where(mask[..., None], sf["dN"], 0.0)
    rng = np.random.default_rng(3)
    G = jnp.asarray(rng.standard_normal((p.count, 3, 3)), jnp.float32)
    f_ref = windowed.p2g(jnp.einsum("pij,pkj->pki", G, dN), box, grid, offsets)

    x_t, lam_t, act_t = _tr(p, box)
    C, nc = box.capacity, box.n_cells
    fN = pt.to_channel_leading(p.mass, C, nc)
    G_t = pt.to_channel_leading(G.reshape(-1, 9), C, nc)
    nodes, _, _ = pt.fused_scatter(grid, box, params, x_t, lam_t, act_t, fN, G_t=G_t)
    np.testing.assert_allclose(np.asarray(nodes[:, 1:]), np.asarray(f_ref),
                               rtol=3e-4, atol=3e-5)


def test_gather3_matches_windowed_g2p_and_gradient():
    grid, box, p, params = _problem3(seed=4)
    sf, offsets, mask = _oracle(grid, box, p, params)
    N = jnp.where(mask, sf["N"], 0.0)
    dN = jnp.where(mask[..., None], sf["dN"], 0.0)
    rng = np.random.default_rng(5)
    field = jnp.asarray(rng.standard_normal((grid.n_nodes, 3)), jnp.float32)
    out_ref = windowed.g2p(field, N, box, grid, offsets)
    u_edges = jnp.where(mask[..., None], field[sf["node_ids"]], 0.0)
    grad_ref = jnp.einsum("pki,pkj->pij", u_edges, dN)

    x_t, lam_t, act_t = _tr(p, box)
    C, nc = box.capacity, box.n_cells
    lam_conv = pt.to_channel_leading(sf["lam"], C, nc)
    outN, grad = pt.fused_gather(
        grid, box, params, x_t, lam_conv, act_t, gN=field, g_grad=field
    )
    sel = np.asarray(p.active)
    np.testing.assert_allclose(np.asarray(outN)[sel], np.asarray(out_ref)[sel],
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(grad)[sel], np.asarray(grad_ref)[sel],
                               rtol=3e-4, atol=3e-5)


def test_explicit_step_pallas_3d_matches_windowed():
    """Full 3D explicit step: pallas path vs windowed path over steps."""
    from nlpartsol.formulations.explicit import ExplicitConfig, explicit_step
    from nlpartsol.models import materials as M

    grid, box, p, params = _problem3(seed=7, n_side=9, n_particles=80)
    rng = np.random.default_rng(8)
    p = p.replace(
        v=jnp.asarray(0.02 * rng.standard_normal((p.count, 3)), jnp.float32)
    )
    mats = M.material_table(
        [M.material(kind="Neo-Hookean-Wriggers", E=1e6, nu=0.3, rho0=1000.0)]
    )
    dt = 0.2 * grid.spacing / np.sqrt(1e6 / 1000.0)
    body = jnp.zeros((3,), jnp.float32)
    common = dict(dt=dt, shapefun="lme", lme_params=params,
                  kinds=(M.NEO_HOOKEAN,), active_box=box)
    cfg_w = ExplicitConfig(transfer="windowed", **common)
    cfg_p = ExplicitConfig(transfer="pallas", **common)
    stepj = jax.jit(explicit_step, static_argnums=(3,))
    pw = pp = p
    for _ in range(4):
        pw, dw = stepj(pw, grid, mats, cfg_w, body)
        pp, dp_ = stepj(pp, grid, mats, cfg_p, body)
    # compare by particle id (slot layouts may differ after rebin)
    def by_pid(q):
        order = np.argsort(np.asarray(q.pid)[np.asarray(q.active)])
        sel = np.asarray(q.active)
        return (np.asarray(q.x)[sel][order], np.asarray(q.v)[sel][order],
                np.asarray(q.F)[sel][order])

    x1, v1, F1 = by_pid(pw)
    x4, v4, F4 = by_pid(pp)
    np.testing.assert_allclose(x4, x1, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(v4, v1, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(F4, F1, rtol=1e-5, atol=1e-7)


def test_implicit_step_pallas_3d_matches_windowed():
    """3D implicit Newmark step: fused-pallas custom-JVP path vs windowed."""
    from nlpartsol.formulations.implicit import ImplicitConfig, implicit_step
    from nlpartsol.models import materials as M

    grid, box, p, params = _problem3(seed=9, n_side=8, n_particles=50)
    rng = np.random.default_rng(10)
    p = p.replace(
        v=jnp.asarray(0.02 * rng.standard_normal((p.count, 3)), jnp.float32)
    )
    mats = M.material_table(
        [M.material(kind="Neo-Hookean-Wriggers", E=1e6, nu=0.3, rho0=1000.0)]
    )
    dt = 0.5 * grid.spacing / np.sqrt(1e6 / 1000.0)
    body = jnp.zeros((3,), jnp.float32)
    common = dict(dt=dt, shapefun="lme", lme_params=params,
                  kinds=(M.NEO_HOOKEAN,), active_box=box,
                  newton_tol=1e-6, newton_maxiter=15)
    cfg_w = ImplicitConfig(transfer="windowed", **common)
    cfg_p = ImplicitConfig(transfer="pallas", **common)
    stepj = jax.jit(implicit_step, static_argnums=(3,))
    pw, dw = stepj(p, grid, mats, cfg_w, body)
    pp, dp_ = stepj(p, grid, mats, cfg_p, body)
    assert bool(dw["converged"]) and bool(dp_["converged"])

    def by_pid(q, arr):
        a = np.asarray(arr)[np.asarray(q.active)]
        return a[np.argsort(np.asarray(q.pid)[np.asarray(q.active)])]

    np.testing.assert_allclose(by_pid(pp, pp.x), by_pid(pw, pw.x),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(by_pid(pp, pp.stress), by_pid(pw, pw.stress),
                               rtol=2e-3, atol=1.0)
