"""Output-parity fixes (round 3): nodal-path CSV reactions (explicit AND
implicit), Gauss-point evolution events, --Print-Convergence monitor, VTK
off-toggle semantics, LME wrapper= key, nlp attr splitting.

Reference seams: NLPS-Out-nodal-path-csv.c, WriteCSV.c:126-158
(Gauss_Point_evolution__InOutFun__), U-Newmark-beta.c:2076-2152 (__monitor),
Read_GramsShapeFun.c:84-190 (wrapper=), WriteVtk.c toggles.
"""

import os
import textwrap

import numpy as np
import pytest

from nlpartsol.io.builder import build_simulation
from nlpartsol.io import csv_out


def write_gid_quad_mesh(path, nx, ny, h):
    lines = ["MESH dimension 2 ElemType Quadrilateral Nnode 4", "Coordinates"]
    nid = 0
    for i in range(nx + 1):
        for j in range(ny + 1):
            nid += 1
            lines.append(f"{nid} {i * h:.6f} {j * h:.6f}")
    lines.append("End Coordinates")
    lines.append("Elements")
    eid = 0
    for i in range(nx):
        for j in range(ny):
            eid += 1
            n00 = i * (ny + 1) + j + 1
            n10 = (i + 1) * (ny + 1) + j + 1
            lines.append(f"{eid} {n00} {n10} {n10 + 1} {n00 + 1}")
    lines.append("End Elements")
    path.write_text("\n".join(lines) + "\n")


@pytest.fixture
def gravity_bar(tmp_path):
    """Axial bar under gravity, ends pinned: total Dirichlet reaction must
    balance the weight (Σ R_x = M·g_x at convergence)."""
    write_gid_quad_mesh(tmp_path / "bg.msh", 12, 2, 0.05)
    write_gid_quad_mesh(tmp_path / "body.msh", 12, 2, 0.05)
    ny1 = 3
    left = [j for j in range(ny1)]
    right = [12 * ny1 + j for j in range(ny1)]
    allnodes = list(range(0, 13 * ny1))
    (tmp_path / "left.txt").write_text("\n".join(map(str, left)))
    (tmp_path / "right.txt").write_text("\n".join(map(str, right)))
    (tmp_path / "all.txt").write_text("\n".join(map(str, allnodes)))
    (tmp_path / "zero.txt").write_text("CONSTANT_CURVE SCALE#0.0\n")

    def nlp(scheme, extra=""):
        return textwrap.dedent(f"""
        NLPS-Solver (Type={scheme}) {{
            CFL=0.25
            Cel=100.0
            N=12
        }}
        GramsBox (Type=GID, File=bg.msh) {{
            GramsBoundary (File=left.txt) {{
                BcDirichlet V.x zero.txt
                BcDirichlet V.y zero.txt
            }}
            GramsBoundary (File=right.txt) {{
                BcDirichlet V.x zero.txt
                BcDirichlet V.y zero.txt
            }}
            GramsBoundary (File=all.txt) {{
                BcDirichlet V.x NULL
                BcDirichlet V.y zero.txt
            }}
        }}
        GramsShapeFun (Type=FEM) {{
        }}
        Define-Material (idx=0, Model=Neo-Hookean-Wriggers) {{
            E=1e7
            nu=0.0
            rho=1000
        }}
        One-Phase-Analysis (File=body.msh, GPxElement=4) {{
        }}
        GramsBodyForces {{
            g.x=-9.81
        }}
        GramsOutputs (i=100) {{
            DIR=out
        }}
        """) + extra
    return tmp_path, nlp


def test_node_recorder_verbatim():
    rec = csv_out.NodeRecorder([7, 3])
    rec.record(0.1, np.array([[1.0, 2.0], [3.0, 4.0]]))  # already gathered
    assert rec.rows[0] == [0.1, 1.0, 2.0, 3.0, 4.0]
    assert rec.header(2) == "t,n7.r.x,n7.r.y,n3.r.x,n3.r.y"
    with pytest.raises(ValueError):
        rec.record(0.2, np.zeros((5, 2)))  # wrong leading dim: not gathered


NODAL_EVENT = """
Out-nodal-path-csv (i_ini=0; i_step=4; i_end=12) {
    DIR=csvout
    PATH=left.txt
}
"""


@pytest.mark.parametrize("scheme", ["NPC-FS", "Newmark-beta-Finite-Strains"])
def test_nodal_csv_reactions(gravity_bar, monkeypatch, tmp_path, scheme):
    """Nodal-kind CSV event: reaction histories must be nonzero (the round-2
    implicit path silently wrote zeros) and the final total Dirichlet x-
    reaction must carry the bar's weight."""
    base, nlp = gravity_bar
    (base / "sim.nlp").write_text(nlp(scheme, NODAL_EVENT))
    setup = build_simulation(str(base / "sim.nlp"))
    assert setup.csv_events and setup.csv_events[0]["kind"] == "nodes"

    monkeypatch.chdir(tmp_path)
    from nlpartsol.driver import run_simulation

    p, hist = run_simulation(setup, write_outputs=True, progress=False)
    path = os.path.join(setup.out_dir, "csvout", "nodes_path_0.csv")
    assert os.path.exists(path)
    lines = open(path).read().strip().splitlines()
    assert lines[0].startswith("t,n")
    rows = np.array([[float(v) for v in ln.split(",")] for ln in lines[1:]])
    # 3 left-end nodes × 2 components + t; records at steps 0,4,8,12
    assert rows.shape[1] == 1 + 3 * 2
    assert np.abs(rows[-1, 1:]).max() > 0.0


def test_implicit_reaction_balances_weight(gravity_bar):
    """Static scheme: Σ_A∈Dirichlet R_x = M_total·g_x exactly at the
    converged state (free-dof residual = 0 + partition of unity)."""
    base, nlp = gravity_bar
    (base / "sim.nlp").write_text(nlp("Static"))
    setup = build_simulation(str(base / "sim.nlp"))
    from nlpartsol.driver import make_step_config
    from nlpartsol.formulations.implicit import implicit_step
    from nlpartsol.formulations.explicit import to_slot_layout
    from nlpartsol.ops import windowed
    import jax.numpy as jnp

    box = windowed.default_box(setup.grid, setup.particles.x, setup.particles.active)
    cfg = make_step_config(setup, transfer="windowed", active_box=box)
    p = to_slot_layout(setup.particles, setup.grid, box)
    body = jnp.asarray(setup.gravity[0])
    p1, diag = implicit_step(p, setup.grid, setup.materials, cfg, body)
    assert "reactions" in diag
    R = np.asarray(diag["reactions"])
    act = np.asarray(p.active)
    Mg = float(np.sum(np.asarray(p.mass, np.float64)[act])) * (-9.81)
    assert abs(R[:, 0].sum() - Mg) < 5e-3 * abs(Mg)


def test_gauss_point_evolution_event(gravity_bar, monkeypatch, tmp_path):
    base, nlp = gravity_bar
    (base / "gp.txt").write_text("1\n2\n")
    (base / "sim.nlp").write_text(nlp("NPC-FS", """
    Out-Gauss-Point-evolution-csv (i_ini=0; i_step=6; i_end=12) {
        DIR=csvout
        PATH=gp.txt
    }
    """))
    setup = build_simulation(str(base / "sim.nlp"))
    ev = setup.csv_events[0]
    assert ev["kind"] == "particles"
    assert set(ev["fields"]) == {"stress", "F", "eps"}

    monkeypatch.chdir(tmp_path)
    from nlpartsol.driver import run_simulation

    p, hist = run_simulation(setup, write_outputs=True, progress=False)
    path = os.path.join(setup.out_dir, "csvout", "particles_path_0.csv")
    lines = open(path).read().strip().splitlines()
    # t + 2 pids × (stress 4 + F 4 + eps 1)
    assert len(lines[1].split(",")) == 1 + 2 * 9
    assert len(lines[0].split(",")) == 1 + 2 * 9  # header matches


def test_print_convergence_monitor(gravity_bar, monkeypatch, tmp_path, capsys):
    base, nlp = gravity_bar
    (base / "sim.nlp").write_text(nlp("Newmark-beta-Finite-Strains"))
    setup = build_simulation(str(base / "sim.nlp"))
    monkeypatch.chdir(tmp_path)
    from nlpartsol.driver import run_simulation

    run_simulation(
        setup, write_outputs=False, progress=False, n_steps=3,
        print_convergence=True,
    )
    out = capsys.readouterr().out
    assert "[NR] step 0:" in out and "|R|=" in out and "CONVERGED" in out


def test_vtk_all_false_toggles_off():
    from nlpartsol.io import vtk

    assert vtk.fields_from_outputs({}) == vtk._DEFAULT_FIELDS
    assert vtk.fields_from_outputs({"Out-velocity": "false"}) == ()
    assert vtk.fields_from_outputs({"Out-velocity": "true"}) == ("velocity",)


def test_nlp_attr_vector_literal():
    from nlpartsol.io.nlp_parser import _parse_attrs

    a = _parse_attrs("File=x.msh, Value={0;10}, i_step=2")
    assert a["File"] == "x.msh"
    assert a["Value"] == "{0;10}"
    assert a["i_step"] == "2"


def test_lme_wrapper_key(gravity_bar):
    base, nlp = gravity_bar
    sim = nlp("NPC-FS").replace(
        "GramsShapeFun (Type=FEM) {\n}",
        "GramsShapeFun (Type=LME) {\n    gamma=3.0\n    wrapper=Nelder-Mead\n}",
    )
    assert "wrapper=Nelder-Mead" in sim
    (base / "sim.nlp").write_text(sim)
    setup = build_simulation(str(base / "sim.nlp"))
    assert setup.shapefun_params["wrapper"] == "Nelder-Mead"
    # guarded λ-solve runs and converges on a real evaluation
    from nlpartsol.shapefun import lme
    import jax.numpy as jnp

    params = lme.LMEParams(**setup.shapefun_params)
    sf = lme.evaluate(
        setup.grid, setup.particles.x,
        jnp.zeros_like(setup.particles.x), params,
    )
    s = np.asarray(sf["N"].sum(axis=1))
    np.testing.assert_allclose(s, 1.0, atol=1e-5)  # partition of unity

    bad = sim.replace("Nelder-Mead", "Simplex")
    (base / "bad.nlp").write_text(bad)
    with pytest.raises(ValueError, match="wrapper"):
        build_simulation(str(base / "bad.nlp"))
