"""Fused LME transfers vs the XLA windowed engine (oracle).

On the CPU the fused transfers run their XLA reference; the Triton kernels
are checked against it in Pallas interpret mode at tiny shapes, and
compiled at real widths by the tests marked ``gpu`` (chip_smoke.py runs
them on the card).  Parity must hold for: λ solve, N-weighted P2G,
grad-weighted P2G (Σ G·∇N), N-gather, and the displacement-gradient gather.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nlpartsol.types import Grid, make_particles
from nlpartsol.ops import pallas_transfer as pt
from nlpartsol.ops import windowed
from nlpartsol.shapefun import lme
from nlpartsol.formulations.explicit import to_slot_layout


def _problem(seed=0, n_side=12, n_particles=150):
    rng = np.random.default_rng(seed)
    h = 1.0 / (n_side - 1)
    grid = Grid(dims=(n_side, n_side), spacing=h, origin=(0.0, 0.0))
    x = rng.uniform(0.15, 0.85, size=(n_particles, 2)).astype(np.float32)
    p = make_particles(
        x,
        mass=rng.uniform(0.5, 2.0, n_particles).astype(np.float32),
        vol0=np.full(n_particles, h * h / 4, np.float32),
    )
    probe = windowed.box_for_extent(grid, [0.1, 0.1], [0.9, 0.9], capacity=1, margin=1)
    cap = windowed.required_capacity(grid, probe, x)
    box = probe.replace(capacity=max(8, cap))
    p = to_slot_layout(p, grid, box)
    params = lme.LMEParams(gamma=3.0)
    return grid, box, p, params


def _oracle(grid, box, p, params):
    sf = lme.evaluate(grid, p.x, p.lme_lambda, params)
    offsets = lme.offsets_for(2, params)
    mask = sf["mask"] & p.active[:, None]
    return sf, offsets, mask


def _tr(p, box):
    C, nc = box.capacity, box.n_cells
    x_t = pt.to_channel_leading(p.x, C, nc)
    lam_t = pt.to_channel_leading(p.lme_lambda, C, nc)
    act_t = pt.to_channel_leading(p.active.astype(jnp.float32), C, nc)
    return x_t, lam_t, act_t


def test_scatter_matches_windowed_p2g():
    grid, box, p, params = _problem()
    sf, offsets, mask = _oracle(grid, box, p, params)
    N = jnp.where(mask, sf["N"], 0.0)

    # oracle: mass + momentum P2G
    rng = np.random.default_rng(1)
    vel = jnp.asarray(rng.standard_normal((p.count, 2)), jnp.float32)
    m_ref = windowed.p2g(N * p.mass[:, None], box, grid, offsets)
    mom = (N * p.mass[:, None])[..., None] * vel[:, None, :]
    mom_ref = windowed.p2g(mom, box, grid, offsets)

    x_t, lam_t, act_t = _tr(p, box)
    C, nc = box.capacity, box.n_cells
    fN = jnp.stack(
        [
            pt.to_channel_leading(p.mass, C, nc)[0],
            pt.to_channel_leading(p.mass * vel[:, 0], C, nc)[0],
            pt.to_channel_leading(p.mass * vel[:, 1], C, nc)[0],
        ]
    )
    nodes, lam_new, nnz = pt.fused_scatter(grid, box, params, x_t, lam_t, act_t, fN)
    np.testing.assert_allclose(np.asarray(nodes[:, 0]), np.asarray(m_ref),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(nodes[:, 1:]), np.asarray(mom_ref),
                               rtol=2e-5, atol=1e-6)
    # λ parity with the XLA solver
    lam_ref = sf["lam"]
    lam_got = pt.from_channel_leading(lam_new)
    sel = np.asarray(p.active)
    np.testing.assert_allclose(np.asarray(lam_got)[sel], np.asarray(lam_ref)[sel],
                               rtol=1e-3, atol=1e-3 / grid.spacing * 1e-3)


def test_scatter_grad_weighted_matches_forces():
    grid, box, p, params = _problem(seed=2)
    sf, offsets, mask = _oracle(grid, box, p, params)
    dN = jnp.where(mask[..., None], sf["dN"], 0.0)

    rng = np.random.default_rng(3)
    G = jnp.asarray(rng.standard_normal((p.count, 2, 2)), jnp.float32)
    fi = jnp.einsum("pij,pkj->pki", G, dN)
    f_ref = windowed.p2g(fi, box, grid, offsets)

    x_t, lam_t, act_t = _tr(p, box)
    C, nc = box.capacity, box.n_cells
    fN = pt.to_channel_leading(p.mass, C, nc)  # dummy N channel
    G_t = pt.to_channel_leading(G.reshape(-1, 4), C, nc)
    nodes, _, _ = pt.fused_scatter(grid, box, params, x_t, lam_t, act_t, fN, G_t=G_t)
    np.testing.assert_allclose(np.asarray(nodes[:, 1:]), np.asarray(f_ref),
                               rtol=3e-4, atol=3e-5)


def test_gather_matches_windowed_g2p_and_gradient():
    grid, box, p, params = _problem(seed=4)
    sf, offsets, mask = _oracle(grid, box, p, params)
    N = jnp.where(mask, sf["N"], 0.0)
    dN = jnp.where(mask[..., None], sf["dN"], 0.0)

    rng = np.random.default_rng(5)
    field = jnp.asarray(rng.standard_normal((grid.n_nodes, 2)), jnp.float32)
    out_ref = windowed.g2p(field, N, box, grid, offsets)
    # displacement gradient: Σ_A u_A ⊗ ∇N_A
    u_edges = field[sf["node_ids"]]
    u_edges = jnp.where(mask[..., None], u_edges, 0.0)
    grad_ref = jnp.einsum("pki,pkj->pij", u_edges, dN)

    x_t, lam_t, act_t = _tr(p, box)
    # gathers run at the λ the step's scatter solved (the oracle's sf["lam"])
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


def test_explicit_step_pallas_matches_windowed():
    """Full explicit step: fused-Pallas path vs windowed path, several steps
    (positions, velocities, F, stress must track within f32 tolerance)."""
    from nlpartsol.formulations.explicit import ExplicitConfig, explicit_step
    from nlpartsol.models import materials as M

    grid, box, p, params = _problem(seed=7, n_side=14, n_particles=200)
    rng = np.random.default_rng(8)
    p = p.replace(
        v=jnp.asarray(0.05 * rng.standard_normal((p.count, 2)), jnp.float32),
        vol0=jnp.full((p.count,), grid.spacing**2 / 4, jnp.float32),
    )
    mats = M.material_table(
        [M.material(kind="Neo-Hookean-Wriggers", E=1e6, nu=0.3, rho0=1000.0)]
    )
    dt = 0.1 * grid.spacing / np.sqrt(1e6 / 1e3)
    kw = dict(dt=dt, shapefun="lme", lme_params=params, kinds=(M.NEO_HOOKEAN,),
              active_box=box)
    cfg_w = ExplicitConfig(transfer="windowed", **kw)
    cfg_p = ExplicitConfig(transfer="pallas", **kw)
    body = jnp.asarray([0.0, -9.81], jnp.float32)

    pw = pp = p
    for _ in range(3):
        pw, dw = explicit_step(pw, grid, mats, cfg_w, body)
        pp, dp = explicit_step(pp, grid, mats, cfg_p, body)

    sel = np.asarray(pw.active)
    assert int(dp["nnz"]) == int(dw["nnz"])
    np.testing.assert_allclose(np.asarray(pp.x)[sel], np.asarray(pw.x)[sel],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(pp.v)[sel], np.asarray(pw.v)[sel],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(pp.F)[sel], np.asarray(pw.F)[sel],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(pp.stress)[sel], np.asarray(pw.stress)[sel],
                               rtol=2e-3, atol=1.0)


def test_rebin_every_matches_per_step_binning():
    """rebin_every=4 with the 1-cell drift margin must reproduce per-step
    binning (the radius mask makes the widened-window basis identical)."""
    from nlpartsol.formulations.explicit import ExplicitConfig, run
    from nlpartsol.models import materials as M

    grid, box, p, params = _problem(seed=11, n_side=9, n_particles=60)
    rng = np.random.default_rng(12)
    p = p.replace(
        v=jnp.asarray(0.1 * rng.standard_normal((p.count, 2)), jnp.float32),
        vol0=jnp.full((p.count,), grid.spacing**2 / 4, jnp.float32),
    )
    mats = M.material_table(
        [M.material(kind="Neo-Hookean-Wriggers", E=1e6, nu=0.3, rho0=1000.0)]
    )
    dt = 0.2 * grid.spacing / np.sqrt(1e6 / 1e3)
    kw = dict(dt=dt, shapefun="lme", lme_params=params, kinds=(M.NEO_HOOKEAN,),
              active_box=box, transfer="pallas")
    p1, _ = run(p, grid, mats, ExplicitConfig(rebin_every=1, **kw), 3)
    p4, _ = run(p, grid, mats, ExplicitConfig(rebin_every=3, **kw), 3)

    # same particles survive; compare by pid (slot layouts may differ)
    def by_pid(pp):
        sel = np.asarray(pp.active)
        order = np.argsort(np.asarray(pp.pid)[sel])
        return (np.asarray(pp.x)[sel][order], np.asarray(pp.v)[sel][order],
                np.asarray(pp.F)[sel][order])
    x1, v1, F1 = by_pid(p1)
    x4, v4, F4 = by_pid(p4)
    np.testing.assert_allclose(x4, x1, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(v4, v1, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(F4, F1, rtol=1e-5, atol=1e-7)


def _tiny(margin):
    """A box of 3 × 16 cells at capacity 2 inside a 9 × 22 grid with an
    offset origin: one kernel tile per capacity rank, both box edges
    inside the grid, windows clipped at the grid's edge."""
    rng = np.random.default_rng(21 + margin)
    h = 0.1
    grid = Grid(dims=(9, 22), spacing=h, origin=(0.3, -0.2))
    box = windowed.ActiveBox(offset=(3, 2), cdims=(3, 16), capacity=2)
    n = 60
    cell = np.stack([rng.integers(3, 6, n), rng.integers(2, 18, n)], -1)
    x = (np.asarray(grid.origin) + (cell + rng.uniform(0.05, 0.95, (n, 2))) * h)
    p = make_particles(
        x.astype(np.float32),
        mass=rng.uniform(0.5, 2.0, n).astype(np.float32),
        vol0=np.full(n, h * h / 4, np.float32),
    )
    p = to_slot_layout(p, grid, box, allow_lost=True)
    params = lme.LMEParams(gamma=3.0)
    x_t, lam_t, act_t = _tr(p, box)
    C, nc = box.capacity, box.n_cells
    fN = jnp.stack([pt.to_channel_leading(c, C, nc)[0]
                    for c in (p.mass, p.mass * p.x[:, 0], 2.0 * p.mass)])
    G_t = pt.to_channel_leading(
        jnp.asarray(rng.standard_normal((p.count, 4)), jnp.float32), C, nc)
    field = jnp.asarray(rng.standard_normal((grid.n_nodes, 2)), jnp.float32)
    return grid, box, params, x_t, lam_t, act_t, fN, G_t, field


def _rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


# f32: the kernels and the reference evaluate the same expressions and sum
# them in another order, so node sums agree to a few ulp of their largest
# value; ∇N passes through a 2×2 inverse, which costs about one more digit.
_TOL_N, _TOL_DN = 1e-5, 1e-4


@pytest.mark.parametrize("margin", [0, 1])
@pytest.mark.parametrize("case", ["solve", "G", "gnorm", "strip"])
def test_triton_scatter_interpret_parity(case, margin):
    """The Triton P2G kernels (Pallas interpret mode) vs the XLA reference:
    N-weighted channels with the λ solve, Σ G·∇N, the Jacobi diagonal
    Σ s·|∇N|², and a strip whose node planes are bounded by
    valid_lo/valid_hi (the sharded path)."""
    grid, box, params, x_t, lam_t, act_t, fN, G_t, _ = _tiny(margin)
    kw = dict(solve=True, margin=margin)
    if case in ("G", "gnorm"):
        kw.update(G_t=G_t, solve=False, gnorm=case == "gnorm")
    if case == "strip":
        kw.update(valid_lo=jnp.asarray([1, 1]), valid_hi=jnp.asarray([7, 20]))
    ref = pt.fused_scatter(grid, box, params, x_t, lam_t, act_t, fN, **kw)
    got = pt.fused_scatter(grid, box, params, x_t, lam_t, act_t, fN,
                           interpret=True, **kw)
    tol = _TOL_DN if case in ("G", "gnorm") else _TOL_N
    assert _rel_err(got[0], ref[0]) < tol
    assert int(got[2]) == int(ref[2]) > 0
    act = np.asarray(act_t).reshape(-1) > 0.5
    lam_g = np.asarray(got[1]).reshape(2, -1)[:, act]
    lam_r = np.asarray(ref[1]).reshape(2, -1)[:, act]
    # λ ~ β·h: Newton stops at ‖r‖ ≤ tol_lambda·radius in both, from
    # differently rounded moments
    assert _rel_err(lam_g, lam_r) < 1e-4


@pytest.mark.parametrize("which", ["N", "grad", "both"])
def test_triton_gather_interpret_parity(which):
    """The Triton G2P kernel (Pallas interpret mode) vs the XLA reference:
    N-weighted gather, displacement gradient, and both in one call."""
    grid, box, params, x_t, lam_t, act_t, fN, _, field = _tiny(1)
    lam_c = pt.fused_scatter(grid, box, params, x_t, lam_t, act_t, fN,
                             margin=1)[1]
    kw = dict(gN=field if which != "grad" else None,
              g_grad=field if which != "N" else None, margin=1)
    ref = pt.fused_gather(grid, box, params, x_t, lam_c, act_t, **kw)
    got = pt.fused_gather(grid, box, params, x_t, lam_c, act_t, interpret=True, **kw)
    for g_, r_, tol in zip(got, ref, (_TOL_N, _TOL_DN)):
        assert (g_ is None) == (r_ is None)
        if r_ is not None:
            assert g_.shape == r_.shape
            assert _rel_err(g_, r_) < tol


@pytest.mark.parametrize("platform, interpret, want", [
    ("gpu", False, "triton"),
    ("cpu", False, "xla"),
    ("cpu", True, "interpret"),
    ("gpu", True, ValueError),
    ("metal", False, ValueError),
    ("rocm", False, ValueError),
])
def test_transfer_impl_choice(platform, interpret, want):
    """A GPU runs the compiled kernels and never interpret mode, the CPU
    runs the reference unless a test asks for interpret mode, and any
    other platform is refused rather than given a stand-in."""
    if want is ValueError:
        with pytest.raises(ValueError):
            pt.transfer_impl(platform, interpret)
    else:
        assert pt.transfer_impl(platform, interpret) == want


def test_geometry_culls_window_rows():
    """The kernels sweep each window row over one contiguous o1 range.
    Radius culling keeps exactly the offsets some particle of the slot
    cell (drifted by up to ``margin`` cells) can reach — 32 of 49 at
    margin 0 and 60 of 81 at margin 1 for γ = 3 — and the P2G output
    region spans the box plus the window."""
    params = lme.LMEParams(gamma=3.0)
    grid = Grid(dims=(40, 50), spacing=0.1, origin=(0.0, 0.0))
    box = windowed.ActiveBox(offset=(1, 10), cdims=(20, 30), capacity=3)
    rm = lme.support_radius(params, 1.0)
    for margin, n in ((0, 32), (1, 60)):
        g = pt._Geom(grid, box, params, margin)
        assert len(g.pairs) == n
        assert sum(hi - lo + 1 for _, lo, hi in g.rows) == n
        # positions within the slot cell (cell units), drifted by ±margin
        u = np.linspace(-margin, 1 + margin, 41)
        pos = np.stack(np.meshgrid(u, u, indexing="ij"), -1).reshape(-1, 2)
        for o0 in range(-g.w, g.w + 1):
            for o1 in range(-g.w, g.w + 1):
                reach = np.min(np.sum((pos - (o0, o1)) ** 2, -1)) <= rm * rm
                assert reach == ((o0, o1) in g.pairs)
        assert g.lo == (0, 10 - g.w)
        assert g.hi == (20 + g.w, 39 + g.w)


def test_valid_bounds_forms():
    """valid_lo/valid_hi: None, an axis-0 scalar, or per-axis arrays —
    always clipped to the local grid."""
    grid = Grid(dims=(12, 9), spacing=0.1, origin=(0.0, 0.0))
    box = windowed.ActiveBox(offset=(0, 0), cdims=(11, 8), capacity=1)
    g = pt._Geom(grid, box, lme.LMEParams(), 0)
    assert pt._valid_bounds(g, None, None).tolist() == [0, 11, 0, 8]
    assert pt._valid_bounds(g, 2, 30).tolist() == [2, 11, 0, 8]
    assert pt._valid_bounds(g, jnp.asarray([-1, 3]),
                            jnp.asarray([5, 6])).tolist() == [0, 5, 3, 6]


def _bench_inputs(n_side, seed=0):
    """The bench problem's slot arrays (bench.py: particles in the central
    half at 2×2 per cell, box = that half + 2 cells, capacity 6)."""
    from bench import build_problem

    grid, p, _, _ = build_problem(n_side=n_side, ppc=2)
    box = windowed.ActiveBox(offset=(n_side // 4 - 2,) * 2,
                             cdims=(n_side // 2 + 4,) * 2, capacity=6)
    p = to_slot_layout(p, grid, box)
    rng = np.random.default_rng(seed)
    x_t, lam_t, act_t = _tr(p, box)
    C, nc = box.capacity, box.n_cells
    fN = jnp.stack([pt.to_channel_leading(c, C, nc)[0]
                    for c in (p.mass, p.mass * p.v[:, 0], p.mass * p.v[:, 1])])
    G_t = pt.to_channel_leading(
        jnp.asarray(rng.standard_normal((p.count, 4)), jnp.float32), C, nc)
    field = jnp.asarray(rng.standard_normal((grid.n_nodes, 2)), jnp.float32)
    return grid, box, x_t, lam_t, act_t, fN, G_t, field


@pytest.mark.gpu
@pytest.mark.parametrize("margin", [0, 1])
def test_triton_kernels_compiled_match_xla(gpu, margin):
    """The compiled Triton kernels vs the XLA reference on the card, on the
    bench problem at 256² (65,536 particles in 104,544 slots)."""
    grid, box, x_t, lam_t, act_t, fN, G_t, field = _bench_inputs(256)
    params = lme.LMEParams(gamma=3.0)
    sc = pt.fused_scatter
    ref_sc = pt._scatter_xla(grid, box, params, x_t, lam_t, act_t, fN, None, True, margin)
    got_sc = sc(grid, box, params, x_t, lam_t, act_t, fN, margin=margin)
    assert _rel_err(got_sc[0], ref_sc[0]) < _TOL_N
    assert int(got_sc[2]) == int(ref_sc[2])
    ref_g = pt._scatter_xla(grid, box, params, x_t, ref_sc[1], act_t, fN, G_t,
                            False, margin, gnorm=True)
    got_g = sc(grid, box, params, x_t, ref_sc[1], act_t, fN, G_t,
               solve=False, margin=margin, gnorm=True)
    assert _rel_err(got_g[0], ref_g[0]) < _TOL_DN
    ref_ga = pt._gather_xla(grid, box, params, x_t, ref_sc[1], act_t, field,
                            field, margin)
    got_ga = pt.fused_gather(grid, box, params, x_t, ref_sc[1], act_t,
                             gN=field, g_grad=field, margin=margin)
    assert _rel_err(got_ga[0], ref_ga[0]) < _TOL_N
    assert _rel_err(got_ga[1], ref_ga[1]) < _TOL_DN


def test_implicit_step_pallas_matches_windowed():
    """Implicit Newmark step: fused-Pallas path (custom-JVP linear ops
    through the kernels) vs the windowed path — dU, stress, convergence."""
    from nlpartsol.formulations.implicit import ImplicitConfig, implicit_step
    from nlpartsol.models import materials as M

    grid, box, p, params = _problem(seed=9, n_side=14, n_particles=180)
    rng = np.random.default_rng(10)
    p = p.replace(
        v=jnp.asarray(0.02 * rng.standard_normal((p.count, 2)), jnp.float32),
        vol0=jnp.full((p.count,), grid.spacing**2 / 4, jnp.float32),
    )
    mats = M.material_table(
        [M.material(kind="Neo-Hookean-Wriggers", E=1e6, nu=0.3, rho0=1000.0)]
    )
    dt = 0.5 * grid.spacing / np.sqrt(1e6 / 1e3)
    kw = dict(dt=dt, shapefun="lme", lme_params=params, kinds=(M.NEO_HOOKEAN,),
              active_box=box, cg_maxiter=100)
    cfg_w = ImplicitConfig(transfer="windowed", **kw)
    cfg_p = ImplicitConfig(transfer="pallas", **kw)
    body = jnp.asarray([0.0, -9.81], jnp.float32)

    pw = pp = p
    for _ in range(2):
        pw, dw = implicit_step(pw, grid, mats, cfg_w, body)
        pp, dp = implicit_step(pp, grid, mats, cfg_p, body)
        assert bool(dw["converged"]) and bool(dp["converged"])
        assert int(dp["lost"]) == 0

    # compare by pid (slot orders may differ between binning flavours)
    def by_pid(q, arr):
        a = np.asarray(arr)[np.asarray(q.active)]
        return a[np.argsort(np.asarray(q.pid)[np.asarray(q.active)])]

    assert int(dp["nnz"]) == int(dw["nnz"])
    np.testing.assert_allclose(by_pid(pp, pp.x), by_pid(pw, pw.x),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(by_pid(pp, pp.v), by_pid(pw, pw.v),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(by_pid(pp, pp.F), by_pid(pw, pw.F),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(by_pid(pp, pp.stress), by_pid(pw, pw.stress),
                               rtol=5e-3, atol=10.0)
