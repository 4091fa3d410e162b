"""I/O layer tests: curves, GiD mesh reader, .nlp parser, builder, VTK,
and the CLI end-to-end on a synthetic bar-vibration case."""

import os
import textwrap

import numpy as np
import jax.numpy as jnp
import pytest

from nlpartsol.utils import curves
from nlpartsol.io import gid_mesh, vtk
from nlpartsol.io.nlp_parser import parse_nlp_text
from nlpartsol.io.builder import build_simulation
from nlpartsol.types import make_particles


def test_curves():
    n = 10
    np.testing.assert_allclose(curves.constant(n, 2.0), 2.0)
    np.testing.assert_allclose(curves.ramp(n, 1.0)[5], 0.5)
    h = curves.heaviside(n, 3.0, 4)
    assert h[4] == 0.0 and h[5] == 3.0
    d = curves.delta(n, 5.0, 3)
    assert d[3] == 5.0 and d.sum() == 5.0
    f = curves.parse_curve_lines(["CONSTANT_CURVE SCALE#1.5", "HEAVISIDE_CURVE SCALE#1 Tc#5"], n)
    assert f[0] == 1.5 and f[9] == 2.5


def write_gid_quad_mesh(path, nx, ny, h):
    """Uniform Q4 grid in GiD ASCII format."""
    with open(path, "w") as fh:
        fh.write(f"MESH dimension 2 ElemType Quadrilateral Nnode 4\n")
        fh.write("Coordinates\n")
        nid = 1
        for i in range(nx + 1):
            for j in range(ny + 1):
                fh.write(f"{nid} {i * h} {j * h}\n")
                nid += 1
        fh.write("End Coordinates\n")
        fh.write("Elements\n")
        eid = 1
        for i in range(nx):
            for j in range(ny):
                n0 = i * (ny + 1) + j + 1
                n1 = (i + 1) * (ny + 1) + j + 1
                fh.write(f"{eid} {n0} {n1} {n1 + 1} {n0 + 1}\n")
                eid += 1
        fh.write("End Elements\n")


def test_gid_reader_and_structured_detection(tmp_path):
    path = tmp_path / "mesh.msh"
    write_gid_quad_mesh(path, 4, 2, 0.5)
    m = gid_mesh.read_gid_mesh(str(path))
    assert m.dimension == 2 and m.elem_type == "Q4"
    assert m.n_nodes == 15 and m.n_elems == 8
    np.testing.assert_allclose(gid_mesh.element_volumes(m), 0.25)
    dims, h, origin = gid_mesh.structured_grid_from_mesh(m)
    assert dims == (5, 3) and h == pytest.approx(0.5) and origin == (0.0, 0.0)
    pos, vol = gid_mesh.seed_particles(m, 4)
    assert pos.shape == (32, 2)
    np.testing.assert_allclose(vol.sum(), 2.0 * 1.0)  # total domain area


def test_nlp_parser_blocks():
    text = textwrap.dedent("""
    ! comment
    NLPS-Solver (Type=NPC-FS) {
        CFL=0.5
        Cel=100.0
        N=40
    }
    GramsBox (Type=GID, File=bg.msh) {
        GramsBoundary (File=left.txt) {
            BcDirichlet V.x curve.txt
            BcDirichlet V.y NULL
        }
    }
    Define-Material (idx=0, Model=Neo-Hookean-Wriggers) {
        E=1e7
        nu=0.0
        rho=1000
    }
    """)
    blocks = parse_nlp_text(text)
    kws = [b.keyword for b in blocks]
    assert "NLPS-Solver" in kws and "GramsBox" in kws and "Define-Material" in kws
    solver = blocks[kws.index("NLPS-Solver")]
    assert solver.attrs["Type"] == "NPC-FS" and solver.props["N"] == 40
    box = blocks[kws.index("GramsBox")]
    bnd = box.child("GramsBoundary")
    assert bnd.attrs["File"] == "left.txt"
    assert ["BcDirichlet", "V.x", "curve.txt"] in bnd.statements


@pytest.fixture
def bar_case(tmp_path):
    """Full synthetic .nlp bar case on disk."""
    write_gid_quad_mesh(tmp_path / "bg.msh", 20, 2, 0.05)
    write_gid_quad_mesh(tmp_path / "body.msh", 20, 2, 0.05)
    # Dirichlet node lists: x-fixed end columns (1-indexed GiD node ids)
    ny1 = 3
    left = [j for j in range(ny1)]
    right = [20 * ny1 + j for j in range(ny1)]
    allnodes = list(range(0, 21 * ny1))
    (tmp_path / "left.txt").write_text("\n".join(map(str, left)))
    (tmp_path / "right.txt").write_text("\n".join(map(str, right)))
    (tmp_path / "all.txt").write_text("\n".join(map(str, allnodes)))
    (tmp_path / "zero.txt").write_text("CONSTANT_CURVE SCALE#0.0\n")
    (tmp_path / "sim.nlp").write_text(textwrap.dedent("""
    NLPS-Solver (Type=NPC-FS) {
        CFL=0.25
        Cel=100.0
        N=20
    }
    GramsBox (Type=GID, File=bg.msh) {
        GramsBoundary (File=left.txt) {
            BcDirichlet V.x zero.txt
            BcDirichlet V.y zero.txt
        }
        GramsBoundary (File=right.txt) {
            BcDirichlet V.x zero.txt
            BcDirichlet V.y zero.txt
        }
        GramsBoundary (File=all.txt) {
            BcDirichlet V.x NULL
            BcDirichlet V.y zero.txt
        }
    }
    GramsShapeFun (Type=FEM) {
    }
    Define-Material (idx=0, Model=Neo-Hookean-Wriggers) {
        E=1e7
        nu=0.0
        rho=1000
    }
    One-Phase-Analysis (File=body.msh, GPxElement=4) {
    }
    GramsOutputs (i=10) {
        DIR=out
    }
    """))
    return tmp_path


def test_builder_and_driver(bar_case, tmp_path, monkeypatch):
    setup = build_simulation(str(bar_case / "sim.nlp"))
    assert setup.grid.dims == (21, 3)
    assert setup.particles.count == 20 * 2 * 4
    assert setup.solver.n_steps == 20
    assert setup.shapefun == "fem"
    # Dirichlet: ends fixed in x, everything fixed in y
    dm = np.asarray(setup.grid.dirichlet_mask).reshape(21, 3, 2)
    assert dm[0, :, 0].all() and dm[-1, :, 0].all() and dm[:, :, 1].all()
    assert not dm[5, 1, 0]

    monkeypatch.chdir(tmp_path)
    from nlpartsol.driver import run_simulation

    # give it an initial velocity mode and run the full loop
    x = np.asarray(setup.particles.x)
    v = 0.01 * np.stack([np.sin(np.pi * x[:, 0] / 1.0), np.zeros(len(x))], -1)
    setup.particles = setup.particles.replace(v=jnp.asarray(v, jnp.float32))
    p, hist = run_simulation(setup, write_outputs=True, progress=False)
    assert np.all(np.isfinite(np.asarray(p.x)))
    assert len(hist["kinetic_energy"]) == 20
    # energy stays near the initial value
    ke0 = hist["kinetic_energy"][0] + hist["strain_energy"][0]
    keN = hist["kinetic_energy"][-1] + hist["strain_energy"][-1]
    assert abs(keN - ke0) / ke0 < 0.1
    assert os.path.exists(setup.out_dir)
    vtks = sorted(f for f in os.listdir(setup.out_dir) if f.endswith(".vtk"))
    # particle cloud AND nodal mesh per output step (WriteVtk.c writes both)
    assert [f for f in vtks if f.startswith("particles_")] == [
        "particles_000000.vtk", "particles_000010.vtk"
    ]
    assert [f for f in vtks if f.startswith("nodes_")] == [
        "nodes_000000.vtk", "nodes_000010.vtk"
    ]
    ntxt = (tmp_path / setup.out_dir / "nodes_000010.vtk").read_text()
    assert "REACTIONS" in ntxt and "DIMENSIONS 21 3 1" in ntxt


def test_vtk_writer_roundtrip(tmp_path):
    p = make_particles(
        np.random.default_rng(0).uniform(0, 1, (7, 2)).astype(np.float32),
        mass=np.ones(7),
        vol0=np.ones(7),
    )
    path = vtk.write_particles_vtk(str(tmp_path / "p.vtk"), p)
    txt = open(path).read()
    assert "POINTS 7 float" in txt and "SCALARS damage" in txt and "TENSORS stress" in txt


def test_cli_runs(bar_case, monkeypatch, capsys):
    monkeypatch.chdir(bar_case)
    from nlpartsol.cli import main

    rc = main(["--FORMULATION-U", "-f", str(bar_case / "sim.nlp"), "--steps", "3", "--no-output"])
    assert rc == 0


def test_checkpoint_roundtrip(tmp_path):
    from nlpartsol.io.checkpoint import load_checkpoint, save_checkpoint

    rng = np.random.default_rng(1)
    p = make_particles(
        rng.uniform(0, 1, (9, 2)).astype(np.float32), mass=np.ones(9), vol0=np.ones(9)
    )
    p = p.replace(eps=jnp.asarray(rng.uniform(size=9), jnp.float32))
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, p, step=42, extra={"rng": np.arange(3)})
    p2, step, extra = load_checkpoint(path)
    assert step == 42
    np.testing.assert_array_equal(np.asarray(p2.x), np.asarray(p.x))
    np.testing.assert_array_equal(np.asarray(p2.eps), np.asarray(p.eps))
    np.testing.assert_array_equal(extra["rng"], np.arange(3))


def test_path_recorder(tmp_path):
    from nlpartsol.io.csv_out import PathRecorder

    p = make_particles(np.zeros((4, 2), np.float32), mass=np.ones(4), vol0=np.ones(4))
    rec = PathRecorder([0, 2], fields=("x",))
    rec.record(0.0, p)
    rec.record(0.1, p.replace(x=p.x + 1.0))
    out = rec.write(str(tmp_path / "path.csv"))
    lines = open(out).read().strip().splitlines()
    assert lines[0].startswith("t,p0.x.x")
    assert len(lines) == 3


@pytest.fixture
def upw_case(tmp_path):
    """Soil-water coupling .nlp case (Generate_Soil_Water_Coupling_Analysis
    analog: Soil-Water-Coupling-One-Layer + Define-Mixture blocks)."""
    write_gid_quad_mesh(tmp_path / "bg.msh", 2, 8, 0.1)
    write_gid_quad_mesh(tmp_path / "body.msh", 2, 8, 0.1)
    ny1, nx1 = 9, 3
    bottom = [j * ny1 for j in range(nx1)]
    allnodes = list(range(0, nx1 * ny1))
    (tmp_path / "bottom.txt").write_text("\n".join(map(str, bottom)))
    (tmp_path / "all.txt").write_text("\n".join(map(str, allnodes)))
    (tmp_path / "zero.txt").write_text("CONSTANT_CURVE SCALE#0.0\n")
    (tmp_path / "grav.txt").write_text("CONSTANT_CURVE SCALE#-9.81\n")
    (tmp_path / "sim.nlp").write_text(textwrap.dedent("""
    NLPS-Solver (Type=NPC-FS) {
        CFL=0.1
        Cel=2400.0
        N=10
    }
    GramsBox (Type=GID, File=bg.msh) {
        GramsBoundary (File=bottom.txt) {
            BcDirichlet V.y zero.txt
        }
        GramsBoundary (File=all.txt) {
            BcDirichlet V.x zero.txt
            BcDirichlet V.y NULL
        }
    }
    GramsShapeFun (Type=FEM) {
    }
    Define-Material (idx=0, Model=Neo-Hookean-Wriggers) {
        E=1e7
        nu=0.3
        rho=2700
    }
    Define-Material (idx=1, Model=Newtonian-Fluid-Compressible) {
        rho=1000
        Compressibility=2.2e9
    }
    Define-Mixture (idx=0) {
        Soil-Idx=0
        Fluid-Idx=1
        Permeability-Skeleton=1e-5
        Reference-Volume-Fraction-Soil=0.6
        Reference-Volume-Fraction-Fluid=0.4
    }
    Soil-Water-Coupling-One-Layer (File=body.msh, GPxElement=4) {
    }
    GramsBodyForces {
        g.y=-9.81
    }
    GramsOutputs (i=100) {
        DIR=out
    }
    """))
    return tmp_path


def test_builder_detects_upw_formulation(upw_case):
    setup = build_simulation(str(upw_case / "sim.nlp"))
    assert setup.formulation == "upw"
    assert setup.mixtures is not None
    # mixture state initialised: ρ_mix = 2700·0.6 + 1000·0.4
    np.testing.assert_allclose(np.asarray(setup.particles.rho), 2020.0, rtol=1e-5)


def test_cli_runs_upw(upw_case, monkeypatch):
    from nlpartsol.cli import main

    monkeypatch.chdir(upw_case)
    rc = main(["--FORMULATION-Upw", "-f", str(upw_case / "sim.nlp"),
               "--steps", "3", "--no-output"])
    assert rc == 0


def test_hydrostatic_and_nodal_initial_conditions(tmp_path):
    """Hydrostatic-condition (NLPS-Hidrostatic-Condition.c) and
    Initial-nodal-values (NLPS-Initial-condition-nodes.c) readers."""
    write_gid_quad_mesh(tmp_path / "bg.msh", 4, 4, 0.25)
    write_gid_quad_mesh(tmp_path / "body.msh", 4, 4, 0.25)
    ny1 = 5
    allnodes = list(range(0, 5 * ny1))
    (tmp_path / "all.txt").write_text("\n".join(map(str, allnodes)))
    (tmp_path / "sim.nlp").write_text(textwrap.dedent("""
    NLPS-Solver (Type=NPC-FS) {
        CFL=0.25
        Cel=10.0
        N=4
    }
    GramsBox (Type=GID, File=bg.msh) {
    }
    GramsShapeFun (Type=FEM) {
    }
    Define-Material (idx=0, Model=Neo-Hookean-Wriggers) {
        E=1e6
        nu=0.3
        rho=2000
    }
    One-Phase-Analysis (File=body.msh, GPxElement=1) {
    }
    Hydrostatic-condition
    {
        Origin = {0 ; 1.0}
        Direction = {0 ; -1}
        Gravity = 10
        MatIndx = 0
    }
    Initial-nodal-values (NODES=all.txt)
    {
        VELOCITY=[2.5,0.0,0.0]
    }
    GramsOutputs (i=10) {
        DIR=out
    }
    """))
    setup = build_simulation(str(tmp_path / "sim.nlp"))
    p = setup.particles
    x = np.asarray(p.x)
    st = np.asarray(p.stress)
    # P = -rho*g*<(x-X0)·dir> = -2000*10*(1.0 - y): compressive below origin
    P_expect = -2000.0 * 10.0 * (1.0 - x[:, 1])
    np.testing.assert_allclose(st[:, 0, 0], P_expect, rtol=1e-6)
    np.testing.assert_allclose(st[:, 1, 1], P_expect, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(p.stress_zz), P_expect, rtol=1e-6)
    # consistent isotropic b_e
    Eh = P_expect * (1 - 2 * 0.3) / 1e6
    np.testing.assert_allclose(
        np.asarray(p.bemi)[:, 0, 0], np.exp(2 * Eh) - 1, rtol=1e-4
    )
    # nodal velocity interpolated: uniform 2.5 in x everywhere
    v = np.asarray(p.v)
    np.testing.assert_allclose(v[:, 0], 2.5, rtol=1e-6)
    np.testing.assert_allclose(v[:, 1], 0.0, atol=1e-12)


def test_vtk_field_toggles(tmp_path):
    """WriteVtk.c field-toggle parity: all fields writable; GramsOutputs
    Out-* keys map through FIELD_ALIASES."""
    import numpy as np
    from nlpartsol.io import vtk
    from nlpartsol.types import make_particles

    p = make_particles(
        np.random.default_rng(0).uniform(0, 1, (5, 2)),
        mass=np.ones(5), vol0=np.ones(5),
    )
    path = vtk.write_particles_vtk(
        str(tmp_path / "all.vtk"), p, fields=vtk.ALL_FIELDS
    )
    text = open(path).read()
    for token in ("stress_eigenvalues", "deformation_gradient",
                  "green_lagrange", "kappa", "volume", "kinetic_energy",
                  "von_mises"):
        assert token in text, token
    got = vtk.fields_from_outputs(
        {"Out-Vel": "true", "Out-Von-Mises": "true",
         "Out-Deformation-Gradient": "true", "Out-Acc": "false"}
    )
    assert set(got) == {"velocity", "von_mises", "deformation_gradient"}
    assert vtk.fields_from_outputs({"DIR": "out"}) == vtk._DEFAULT_FIELDS


def test_csv_path_events(bar_case, tmp_path, monkeypatch):
    """Event-driven Gauss-point/particle-path CSV outputs
    (NLPS-Out-particle-path-csv.c flow)."""
    (bar_case / "pids.txt").write_text("0\n4\n")
    nlp = (bar_case / "sim.nlp").read_text()
    nlp += textwrap.dedent("""
    Out-particles-path-csv (i_ini=0; i_step=7; i_end=20) {
        DIR=csvout
        PATH=pids.txt
        Out-velocity=true
        Out-damage=true
    }
    """)
    (bar_case / "sim2.nlp").write_text(nlp)
    setup = build_simulation(str(bar_case / "sim2.nlp"))
    assert len(setup.csv_events) == 1
    ev = setup.csv_events[0]
    assert ev["kind"] == "particles" and list(ev["ids"]) == [0, 4]
    assert set(ev["fields"]) == {"v", "damage"}

    monkeypatch.chdir(tmp_path)
    from nlpartsol.driver import run_simulation

    p, hist = run_simulation(setup, write_outputs=True, progress=False)
    path = os.path.join(setup.out_dir, "csvout", "particles_path_0.csv")
    assert os.path.exists(path)
    lines = open(path).read().strip().splitlines()
    # header + records at steps 0, 7, 14 (i_step=7 within 20 steps)
    assert len(lines) == 1 + 3
    assert lines[0].startswith("t,p0.v")
    assert len(lines[1].split(",")) == 1 + 2 * (2 + 1)  # t + 2 pids × (v2, damage)


@pytest.fixture
def fracture_bar_case(tmp_path):
    """Notched-bar analog: two halves pulled apart; eigenerosion must sever
    the center (the reference flow: --Fracture-Modulus Eigenerosion with
    Ceps/Gf material params, driver-nl-partsol.c:133-143)."""
    write_gid_quad_mesh(tmp_path / "bg.msh", 24, 6, 0.05)
    write_gid_quad_mesh(tmp_path / "body.msh", 16, 2, 0.05)
    (tmp_path / "lefthalf.txt").write_text(
        "\n".join(str(e) for e in range(0, 16) if (e // 2) < 4)
    )
    (tmp_path / "righthalf.txt").write_text(
        "\n".join(str(e) for e in range(0, 16 * 2) if (e // 2) >= 12)
    )
    (tmp_path / "sim.nlp").write_text(textwrap.dedent("""
    NLPS-Solver (Type=NPC-FS) {
        CFL=0.2
        Cel=100.0
        N=60
    }
    GramsBox (Type=GID, File=bg.msh) {
    }
    GramsShapeFun (Type=LME) {
        gamma=3.0
    }
    Define-Material (idx=0, Model=Neo-Hookean-Wriggers) {
        E=1e6
        nu=0.2
        rho=1000
        Ceps=1.5
        Gf=0.08
    }
    One-Phase-Analysis (File=body.msh, GPxElement=4) {
    }
    GramsInitials (Nodes=lefthalf.txt) {
        Value=[-1.0;0.0]
    }
    GramsInitials (Nodes=righthalf.txt) {
        Value=[1.0;0.0]
    }
    GramsOutputs (i=20) {
        DIR=out
    }
    """))
    return tmp_path


def test_cli_fracture_modulus(fracture_bar_case, monkeypatch):
    """End-to-end fracture activation from the CLI:
    the eroded center must appear in the emitted VTK damage field."""
    import re

    from nlpartsol.cli import main

    monkeypatch.chdir(fracture_bar_case)
    rc = main([
        "--FORMULATION-U", "-f", "sim.nlp",
        "--Fracture-Modulus", "Eigenerosion", "--transfer", "windowed",
    ])
    assert rc == 0
    vtks = sorted(os.listdir("out"))
    last = [f for f in vtks if f.startswith("particles_")][-1]
    txt = (fracture_bar_case / "out" / last).read_text()
    m = re.search(r"SCALARS damage[^\n]*\nLOOKUP_TABLE default\n((?:[^A-Z]+\n)+)", txt)
    assert m, "damage field missing from VTK output"
    dmg = np.fromstring(m.group(1), sep=" ") if hasattr(np, "fromstring") else None
    dmg = np.array([float(v) for v in m.group(1).split()])
    assert dmg.max() == 1.0, "no particle eroded"
    assert dmg.min() == 0.0, "everything eroded"


def test_cli_fracture_modulus_rejects_unknown(fracture_bar_case, monkeypatch):
    from nlpartsol.cli import main

    monkeypatch.chdir(fracture_bar_case)
    with pytest.raises(SystemExit, match="Eigenerosion or"):
        main(["-f", "sim.nlp", "--Fracture-Modulus", "PhaseField"])


@pytest.mark.parametrize("scheme", ["FE", "Generalized-alpha"])
def test_driver_dispatches_fe_and_generalized_alpha(bar_case, tmp_path, monkeypatch, scheme):
    """A deck requesting Type=FE / Type=Generalized-alpha must run the
    matching integrator (U-Forward-Euler.c:19 / U-Generalized-Alpha.c:18
    dispatched from driver-nl-partsol.c:349-379), not silently the NPC-FS
    predictor-corrector."""
    txt = (bar_case / "sim.nlp").read_text().replace("Type=NPC-FS", f"Type={scheme}")
    if scheme == "Generalized-alpha":
        txt = txt.replace("N=20", "N=20\n    rb-Generalized-alpha=0.8")
    (bar_case / "sim.nlp").write_text(txt)
    setup = build_simulation(str(bar_case / "sim.nlp"))

    from nlpartsol.driver import make_step_config, run_simulation
    from nlpartsol.formulations.explicit import ExplicitConfig, to_slot_layout
    from nlpartsol.ops import windowed

    box = windowed.default_box(setup.grid, setup.particles.x, setup.particles.active)
    cfg = make_step_config(setup, transfer="pallas", active_box=box)
    assert isinstance(cfg, ExplicitConfig)
    assert cfg.scheme == scheme
    assert cfg.transfer == "windowed"  # no fused-pallas path for FE/GA
    if scheme == "Generalized-alpha":
        assert cfg.ga_rb == pytest.approx(0.8)

    # driver trajectory == direct stepping with the scheme's own step fn
    monkeypatch.chdir(tmp_path)
    x = np.asarray(setup.particles.x)
    v = 0.01 * np.stack([np.sin(np.pi * x[:, 0] / 1.0), np.zeros(len(x))], -1)
    setup.particles = setup.particles.replace(v=jnp.asarray(v, jnp.float32))
    p_drv, _ = run_simulation(
        setup, transfer="windowed", write_outputs=False, progress=False, n_steps=3
    )

    from nlpartsol.formulations.integrators import (
        forward_euler_step,
        generalized_alpha_step,
    )

    cfg = make_step_config(setup, transfer="windowed", active_box=box)
    p_man = to_slot_layout(setup.particles, setup.grid, box)
    body = jnp.zeros((2,), p_man.x.dtype)
    g = setup.grid.replace(
        dirichlet_value=jnp.zeros_like(setup.grid.dirichlet_value)
    )
    for _ in range(3):
        if scheme == "FE":
            p_man, _ = forward_euler_step(p_man, g, setup.materials, cfg, body)
        else:
            p_man, _ = generalized_alpha_step(
                p_man, g, setup.materials, cfg, body, cfg.ga_rb
            )
    np.testing.assert_allclose(
        np.asarray(p_drv.x), np.asarray(p_man.x), rtol=1e-6, atol=1e-9
    )


def test_mixture_formulations_reject_fe_scheme(upw_case):
    setup = build_simulation(str(upw_case / "sim.nlp"))
    setup.solver.scheme = "FE"
    from nlpartsol.driver import make_step_config

    with pytest.raises(ValueError, match="single-phase"):
        make_step_config(setup, transfer="windowed")


def test_transfer_auto_selects_engine(bar_case):
    """--transfer auto (the default): fused-pallas when the step is
    eligible, windowed otherwise."""
    from nlpartsol.driver import make_step_config

    # FEM shape functions: ineligible for the fused kernels -> windowed
    setup = build_simulation(str(bar_case / "sim.nlp"))
    cfg = make_step_config(setup, transfer="auto")
    assert cfg.transfer == "windowed"

    # LME on the structured grid, NPC-FS, -u: eligible -> pallas
    txt = (bar_case / "sim.nlp").read_text().replace("Type=FEM", "Type=LME")
    (bar_case / "sim.nlp").write_text(txt)
    setup = build_simulation(str(bar_case / "sim.nlp"))
    cfg = make_step_config(setup, transfer="auto")
    assert cfg.transfer == "pallas"


def test_backup_and_resume_reproduces_trajectory(bar_case, tmp_path, monkeypatch):
    """Kill-and-resume: a run interrupted at the backup
    step, resumed from <out_dir>/backup.npz, reproduces the uninterrupted
    trajectory (reference i0/InitialTimeStep semantics with state actually
    loaded; the reference's own Backup_* globals are dead, Globals.h:105-109)."""
    monkeypatch.chdir(tmp_path)

    def fresh_setup():
        setup = build_simulation(str(bar_case / "sim.nlp"))
        x = np.asarray(setup.particles.x)
        v = 0.01 * np.stack([np.sin(np.pi * x[:, 0] / 1.0), np.zeros(len(x))], -1)
        setup.particles = setup.particles.replace(v=jnp.asarray(v, jnp.float32))
        return setup

    from nlpartsol.driver import run_simulation

    # uninterrupted: 20 steps
    p_full, _ = run_simulation(
        fresh_setup(), write_outputs=False, progress=False, n_steps=20
    )
    # interrupted: first 10 steps with backups every 10 (simulated kill)
    run_simulation(
        fresh_setup(), write_outputs=False, progress=False, n_steps=10,
        backup_every=10,
    )
    bkp = os.path.join("out", "backup.npz")
    assert os.path.exists(bkp)
    from nlpartsol.io.checkpoint import load_checkpoint

    _, step0, _ = load_checkpoint(bkp)
    assert step0 == 10
    # resumed: continues the 20-step schedule from step 10
    p_res, hist = run_simulation(
        fresh_setup(), write_outputs=False, progress=False, n_steps=20,
        resume=bkp,
    )
    assert len(hist["kinetic_energy"]) == 10  # only the remaining steps ran
    # compare by stable particle identity (slot layouts may differ)
    act_f = np.asarray(p_full.active)
    act_r = np.asarray(p_res.active)
    xf = np.asarray(p_full.x)[act_f][np.argsort(np.asarray(p_full.pid)[act_f])]
    xr = np.asarray(p_res.x)[act_r][np.argsort(np.asarray(p_res.pid)[act_r])]
    np.testing.assert_allclose(xr, xf, rtol=1e-5, atol=1e-8)


def test_cli_backup_resume_and_deck_key(bar_case, monkeypatch):
    monkeypatch.chdir(bar_case)
    txt = (bar_case / "sim.nlp").read_text().replace(
        "DIR=out", "DIR=out\n        Out-backup=5"
    )
    (bar_case / "sim.nlp").write_text(txt)
    setup = build_simulation(str(bar_case / "sim.nlp"))
    assert setup.backup_every == 5

    from nlpartsol.cli import main

    rc = main(["-f", "sim.nlp", "--steps", "5", "--no-output"])
    assert rc == 0
    assert os.path.exists("out/backup.npz")
    rc = main(["-f", "sim.nlp", "--steps", "10", "--no-output",
               "--resume", "out/backup.npz"])
    assert rc == 0


def test_traction_alignment_windowed_vs_scatter(bar_case, tmp_path, monkeypatch):
    """Neumann tractions are defined on ORIGINAL particle ids; the windowed
    slot permutation must not scramble them (regression: tables are routed
    through the stable pid)."""
    # add an end-load on the last particle column
    setup0 = build_simulation(str(bar_case / "sim.nlp"))
    x0 = np.asarray(setup0.particles.x)
    right_ids = np.where(x0[:, 0] > x0[:, 0].max() - 0.03)[0]
    (bar_case / "load_ids.txt").write_text("\n".join(map(str, right_ids)))
    (bar_case / "pull.txt").write_text("CONSTANT_CURVE SCALE#1e4\n")
    txt = (bar_case / "sim.nlp").read_text().replace(
        "One-Phase-Analysis",
        "Define-Neumann-Boundary (File=load_ids.txt) {\n"
        "    BcNeumann T.x pull.txt\n"
        "}\nOne-Phase-Analysis",
        1,
    )
    # free the right end so the traction does work
    txt = txt.replace(
        "GramsBoundary (File=right.txt) {\n"
        "        BcDirichlet V.x zero.txt\n"
        "        BcDirichlet V.y zero.txt\n"
        "    }\n    ", "", 1)
    (bar_case / "sim.nlp").write_text(txt)
    monkeypatch.chdir(tmp_path)

    from nlpartsol.driver import run_simulation

    import jax

    perm = np.random.default_rng(3).permutation(setup0.particles.count)
    outs = {}
    for transfer in ("windowed", "scatter"):
        setup = build_simulation(str(bar_case / "sim.nlp"))
        assert setup.neumann, "deck lost its Neumann block"
        # scramble the storage order (pid tracks the ORIGINAL identity, so
        # the Neumann id lists must still address the right particles even
        # though slot order now differs from seeding order)
        shuffled = jax.tree_util.tree_map(
            lambda a: a[perm], setup.particles
        )
        setup.particles = shuffled
        p, _ = run_simulation(
            setup, transfer=transfer, write_outputs=False, progress=False,
            n_steps=8,
        )
        act = np.asarray(p.active)
        order = np.argsort(np.asarray(p.pid)[act])
        outs[transfer] = np.asarray(p.x)[act][order]
    # the bar must actually stretch under the load...
    assert outs["scatter"][:, 0].max() > x0[:, 0].max() + 1e-6
    # ...identically under both engines
    np.testing.assert_allclose(
        outs["windowed"], outs["scatter"], rtol=1e-5, atol=1e-8
    )
