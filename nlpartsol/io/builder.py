"""Builds runnable simulations from parsed .nlp blocks.

The analog of the reference's setup flow (driver-nl-partsol.c:298-344:
Solver_selector → gravity → GramsBox → Generate_One_Phase_Analysis →
GramsOutputs → initialise_shapefun): reads the background mesh (structured
Cartesian detection), seeds particles from the particle-source GiD mesh with
GPxElement, assembles the material table, Dirichlet masks/curves, Neumann
loads, gravity curves, and solver config.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import jax.numpy as jnp

from .. import config
from ..models import materials as M
from ..shapefun import femesh
from ..types import Grid, Particles, make_particles
from ..utils import curves
from . import gid_mesh
from .nlp_parser import (
    Block,
    find,
    find_all,
    parse_nlp,
    parse_vector,
    read_curve_file,
    read_node_list,
)

# reference material Model= names (Read_GramsMaterials2.c dispatch) → kinds
_MODEL_NAMES = dict(M.KIND_NAMES)
_MODEL_NAMES.update(
    {
        "Neo-Hookean": M.NEO_HOOKEAN,
        "Drucker-Prager-Plane-Strain": M.DRUCKER_PRAGER,
        "Drucker-Prager-Outer-Cone": M.DRUCKER_PRAGER,
    }
)

# reference property spellings → MaterialTable fields
_MAT_KEYS = {
    "rho": "rho0",
    "E": "E",
    "nu": "nu",
    "Ceps": "Ceps",
    "Gf": "Gf",
    "ft": "ft",
    "heps": "heps",
    "wcrit": "wcrit",
    "Yield-stress": "kappa0",
    "kappa-0": "kappa0",
    "Hardening-Modulus": "hardening_modulus",
    "Hardening-modulus": "hardening_modulus",
    "theta": "theta_voce",
    "K-0": "K0_voce",
    "K-inf": "Kinf_voce",
    "delta": "delta_voce",
    "m": "exponent_ortiz",
    "Hardening-exponent": "exponent_ortiz",
    "Reference-plastic-strain": "plastic_strain_0",
    "Reference-pressure": "reference_pressure",
    "Cohesion": "cohesion",
    "Friction-angle": "friction_angle",
    "Dilatancy-angle": "dilatancy_angle",
    "J2-degradated": "J2_degradated",
    "Viscosity": "viscosity",
    "n-Macdonald": "n_macdonald",
    "Macdonald-parameter": "n_macdonald",
    "Compressibility": "compressibility",
    "Reference-Pressure": "reference_pressure",
    "Fbar": "alpha_fbar",
    "alpha-Fbar": "alpha_fbar",
    # Borja frictional family (reference Plasticity/Lade-Duncan.c reader
    # keys; shared by Matsuoka-Nakai / Lade-Duncan / Modified-Lade-Duncan)
    "a1": "a1_borja",
    "a2": "a2_borja",
    "a3": "a3_borja",
    "alpha": "alpha_borja",
    "Atmospheric-pressure": "atmospheric_pressure",
    "m-Frictional": "m_frictional",
    "EPS-0": "plastic_strain_0",
    # Bingham (Papanastasiou) regularisation
    "Fluidity-parameter": "fluidity_param",
    # Mooney-Rivlin moduli (reference mu_Ogden[0..1])
    "mu-1": "mu1_mr",
    "mu-2": "mu2_mr",
}


@dataclass
class SolverParams:
    scheme: str = "NPC-FS"
    cfl: float = 0.8
    cel: float = 0.0
    n_steps: int = 0
    i0: int = 0
    epsilon: float = 1.0
    beta: float = 0.25
    gamma: float = 0.5
    tol: float = 1e-5
    max_iter: int = 20
    # Generalized-alpha spectral radius (rb-Generalized-alpha deck key,
    # Read_GramsTime.c:152-155; used by U-Generalized-Alpha.c:126-129)
    rb: float = 0.6


@dataclass
class SimulationSetup:
    solver: SolverParams
    grid: Grid
    particles: Particles
    materials: M.MaterialTable
    kinds: tuple
    shapefun: str = "lme"
    shapefun_params: dict = field(default_factory=dict)
    gravity: Optional[np.ndarray] = None  # (n_steps, d) body acceleration
    # Dirichlet curves: (n_steps, n_nodes, d)? too big — store per-boundary
    dirichlet_nodes: list = field(default_factory=list)  # [(ids, dim, curve)]
    neumann: list = field(default_factory=list)  # [(particle_ids, dim, curve)]
    out_dir: str = "output"
    out_every: int = 100
    # VTK particle fields (GramsOutputs Out-* toggles; None = defaults)
    vtk_fields: tuple = None
    # Event-driven CSV outputs (Out-particles-path-csv / Out-nodal-path-csv
    # blocks; list of dicts with kind/ids/fields/i_start/i_step/i_end/dir)
    csv_events: list = field(default_factory=list)
    # formulation: 'u' (single phase), 'up' (mixed u-p), 'upw' (soil-water)
    formulation: str = "u"
    mixtures: object = None  # formulations.upw.MixtureTable for -upw
    pw_dirichlet: list = field(default_factory=list)  # [(node_ids, curve)]
    # periodic checkpoint backup: write a resumable snapshot every N steps
    # (Out-backup deck key in GramsOutputs; the reference declares
    # Backup_* globals but never implements them, Globals.h:105-109 —
    # SURVEY §5.4 assigns this as new required work). 0 = off.
    backup_every: int = 0
    # nonlocal fracture driver: None | 'eigenerosion' | 'eigensoftening'
    # (the reference's --Fracture-Modulus CLI switch /
    # Driver_EigenErosion/Driver_EigenSoftening globals,
    # driver-nl-partsol.c:133-143; also settable from the deck via
    # `Fracture-Modulus=...` in the NLPS-Solver block)
    fracture: Optional[str] = None


def _mixtures(blocks):
    """Parse Define-Mixture blocks (the reference's soil-water mixture
    reader, src/InOutFun/Material/NLPS-Read-Material-Mixtures.c:114-224:
    Soil-Idx, Fluid-Idx, Permeability-Skeleton,
    Reference-Volume-Fraction-{Soil,Fluid})."""
    rows = {}
    for b in find_all(blocks, "Define-Mixture", "GramsMixture"):
        idx = int(b.attrs.get("idx", b.attrs.get("Id", len(rows))))
        p = b.props
        rows[idx] = dict(
            soil_id=int(p.get("Soil-Idx", 0)),
            water_id=int(p.get("Fluid-Idx", p.get("Water-Idx", 1))),
            phi_s0=float(p.get("Reference-Volume-Fraction-Soil", 0.6)),
            phi_f0=float(p.get("Reference-Volume-Fraction-Fluid", 0.4)),
            permeability=float(p.get("Permeability-Skeleton", p.get("Permeability", 0.0))),
        )
    if not rows:
        return None
    from ..formulations.upw import make_mixture_table

    return make_mixture_table([rows[i] for i in sorted(rows)])


def _solver_params(blocks) -> SolverParams:
    b = find(blocks, "NLPS-Solver", "GramsTime")
    sp = SolverParams()
    if b is None:
        return sp
    sp.scheme = str(b.attrs.get("Type", sp.scheme))
    p = b.props
    sp.cfl = float(p.get("CFL", sp.cfl))
    sp.cel = float(p.get("Cel", sp.cel))
    sp.n_steps = int(p.get("N", sp.n_steps))
    sp.i0 = int(p.get("i0", sp.i0))
    sp.epsilon = float(p.get("Epsilon", sp.epsilon))
    sp.beta = float(p.get("Beta-Newmark-beta", sp.beta))
    sp.gamma = float(p.get("Gamma-Newmark-beta", sp.gamma))
    sp.tol = float(p.get("TOL-Newmark-beta", p.get("TOL-Generalized-alpha", sp.tol)))
    sp.max_iter = int(p.get("Max-Iter", sp.max_iter))
    sp.rb = float(p.get("rb-Generalized-alpha", sp.rb))
    return sp


def _materials(blocks) -> M.MaterialTable:
    rows = {}
    for b in find_all(blocks, "Define-Material", "GramsMaterials"):
        idx = int(b.attrs.get("idx", b.attrs.get("Id", len(rows))))
        model = str(b.attrs.get("Model", b.attrs.get("Type", "Neo-Hookean-Wriggers")))
        if model not in _MODEL_NAMES:
            raise ValueError(f"unknown material model: {model}")
        kw = {"kind": _MODEL_NAMES[model]}
        for key, val in b.props.items():
            if key in _MAT_KEYS and val != "":
                kw[_MAT_KEYS[key]] = float(val)
        rows[idx] = M.material(**kw)
    if not rows:
        raise ValueError("no materials defined (Define-Material)")
    return M.material_table([rows[i] for i in sorted(rows)])


def _shapefun(blocks):
    b = find(blocks, "GramsShapeFun")
    if b is None:
        return "lme", {}
    kind = str(b.attrs.get("Type", "LME")).lower()
    kind = {"fem": "fem", "ugimp": "gimp", "lme": "lme", "alme": "alme"}.get(kind, kind)
    params = {}
    p = b.props
    if "gamma" in p:
        params["gamma"] = float(p["gamma"])
    if "TOL-Zero" in p:
        params["tol_zero"] = float(p["TOL-Zero"])
    if "MaxIter" in p:
        params["max_iter"] = int(p["MaxIter"])
    if "TOL-Wrapper" in p:
        params["tol_lambda"] = float(p["TOL-Wrapper"])
    if "wrapper" in p:
        w = str(p["wrapper"])
        if w.lower().replace("_", "-") not in ("newton-raphson", "nelder-mead"):
            raise ValueError(
                f"GramsShapeFun wrapper={w!r}: expected Newton-Raphson or "
                "Nelder-Mead (Read_GramsShapeFun.c:84-190)"
            )
        params["wrapper"] = w
    return kind, params


def build_simulation(path: str) -> SimulationSetup:
    base = os.path.dirname(os.path.abspath(path))
    blocks = parse_nlp(path)
    sp = _solver_params(blocks)

    # --- background grid (GramsBox) ---
    box = find(blocks, "GramsBox")
    if box is None:
        raise ValueError("GramsBox block required")
    mesh_file = os.path.join(base, str(box.attrs["File"]))
    bg = gid_mesh.read_gid_mesh(mesh_file)
    try:
        dims, h, origin = gid_mesh.structured_grid_from_mesh(bg)
        unstructured = False
        d = len(dims)
        n_nodes = int(np.prod(dims))
        # GiD node ids → structured flat index mapping
        rel = np.round((bg.coords - np.asarray(origin)) / h).astype(np.int64)
        strides = np.concatenate([np.cumprod(np.asarray(dims[::-1]))[-2::-1], [1]])
        gid2flat = (rel * strides).sum(axis=1)
    except ValueError:
        # non-Cartesian background mesh: unstructured isoparametric-element
        # path (reference GramsBox Type=GID on T3/Q4/T4/H8 meshes,
        # Read_GramsBox.c:54-150) — GiD node ids map 1:1
        unstructured = True
        d = bg.dimension
        n_nodes = bg.n_nodes
        gid2flat = np.arange(n_nodes, dtype=np.int64)

    # --- Dirichlet boundaries ---
    dmask = np.zeros((n_nodes, d), bool)
    dirichlet_nodes = []
    for bnd in box.all("GramsBoundary"):
        ids = read_node_list(os.path.join(base, str(bnd.attrs["File"])))
        flat = gid2flat[ids]
        for st in bnd.statements:
            if st[0] != "BcDirichlet":
                continue
            comp = {"V.x": 0, "U.x": 0, "V.y": 1, "U.y": 1, "V.z": 2, "U.z": 2}[st[1]]
            if st[2] == "NULL":
                continue
            dmask[flat, comp] = True
            curve = read_curve_file(os.path.join(base, st[2]), max(sp.n_steps, 1))
            dirichlet_nodes.append((flat, comp, curve))

    if unstructured:
        grid = femesh.from_gid(bg, dirichlet_mask=dmask)
    else:
        grid = Grid(
            dims=tuple(dims),
            spacing=h,
            origin=tuple(origin),
            dirichlet_mask=jnp.asarray(dmask),
            dirichlet_value=jnp.zeros((n_nodes, d), config.dtype()),
        )

    # --- materials ---
    mats = _materials(blocks)
    kinds = mats.kinds_present()

    # --- particles (One-Phase-Analysis / Soil-Water-Coupling) ---
    ana = find(blocks, "One-Phase-Analysis", "GramsSolid", "GramsSolid2D")
    formulation = "u"
    if ana is None:
        ana = find(blocks, "Soil-Water-Coupling-One-Layer", "Soil-Water-Coupling-Analysis")
        if ana is not None:
            formulation = "upw"
    if ana is None:
        raise ValueError("One-Phase-Analysis / GramsSolid / "
                         "Soil-Water-Coupling-One-Layer block required")
    pmesh = gid_mesh.read_gid_mesh(os.path.join(base, str(ana.attrs["File"])))
    gpx = int(ana.attrs.get("GPxElement", 1))
    pos, vol = gid_mesh.seed_particles(pmesh, gpx)
    mat_id = np.zeros(len(pos), np.int32)  # single-material bodies (ref behavior)
    rho0 = np.asarray(mats.rho0)[mat_id]
    particles = make_particles(
        pos, mass=rho0 * vol, vol0=vol, mat_id=mat_id
    )
    # kappa initialised to the material's reference hardening
    particles = particles.replace(kappa=jnp.asarray(np.asarray(mats.kappa0)[mat_id]))

    # --- initial conditions ---
    for ic in find_all(blocks, "GramsInitials"):
        # reference syntax: GramsInitials (Nodes=list.txt) { Value=[vx,vy] }
        # (Read_GramsInitials.c:12-13); File= and V.x= forms also accepted.
        # The list holds SOURCE-MESH ELEMENT ids: the reference applies the
        # value to particles Array_Nodes[i]*GPxElement + j
        # (Read_GramsInitials.c:141-148) and our seeding is elem-major too.
        lf = ic.attrs.get("Nodes", ic.attrs.get("File"))
        if lf is not None:
            eids = read_node_list(os.path.join(base, str(lf)))
            ids = (eids[:, None] * gpx + np.arange(gpx)[None, :]).reshape(-1)
            ids = ids[ids < len(pos)]
        else:
            ids = np.arange(len(pos))
        v0 = np.array(particles.v)
        for key, val in ic.props.items():
            comp = {"V.x": 0, "V.y": 1, "V.z": 2}.get(key)
            if comp is not None:
                v0[ids, comp] = float(val)
            elif key.lower() == "value":
                vec = parse_vector(val)
                v0[ids, : len(vec[:d])] = vec[:d]
        particles = particles.replace(v=jnp.asarray(v0))

    # --- hydrostatic initial stress (NLPS-Hidrostatic-Condition.c) ---
    # P(x) = −ρ·g·⟨(x − X₀)·dir⟩ + P₀ added to the stress diagonal (+zz).
    # Extension over the reference: the equivalent isotropic elastic left Cauchy-Green
    # is initialised too, so state-driven models (b_e-based return mappings)
    # actually carry the prestress — the reference only writes Phi.Stress,
    # which its own Stress_integration overwrites on step 1.
    for hc in find_all(blocks, "Hydrostatic-condition", "Hidrostatic-condition"):
        pf = hc.attrs.get("Particles") or hc.props.get("Particles")
        if pf:
            el_ids = read_node_list(os.path.join(base, str(pf)))
            ids = (el_ids[:, None] * gpx + np.arange(gpx)[None, :]).reshape(-1)
        else:
            ids = np.arange(len(pos))
        origin_v = parse_vector(hc.props.get("Origin", "{0;0;0}"))
        direction = parse_vector(hc.props.get("Direction", "{0;-1;0}"))
        g_mag = float(hc.props.get("Gravity", 0.0))
        mi = int(hc.props.get("MatIndx", 0))
        rho_m = float(np.asarray(mats.rho0)[mi])
        P0 = float(np.asarray(mats.reference_pressure)[mi])
        dist = (pos[ids] - origin_v[:d]) @ direction[:d]
        P = -rho_m * g_mag * dist + P0
        st = np.asarray(particles.stress).copy()
        szz = np.asarray(particles.stress_zz).copy()
        for j in range(d):
            st[ids, j, j] += P
        szz[ids] += P
        # consistent isotropic b_e: E_h = P(1−2ν)/E per principal component
        E_m = float(np.asarray(mats.E)[mi])
        nu_m = float(np.asarray(mats.nu)[mi])
        Eh = P * (1.0 - 2.0 * nu_m) / E_m
        be_d = np.exp(2.0 * Eh) - 1.0
        bemi = np.asarray(particles.bemi).copy()
        bemi_zz = np.asarray(particles.bemi_zz).copy()
        for j in range(d):
            bemi[ids, j, j] = be_d
        bemi_zz[ids] = be_d
        particles = particles.replace(
            stress=jnp.asarray(st), stress_zz=jnp.asarray(szz),
            bemi=jnp.asarray(bemi), bemi_zz=jnp.asarray(bemi_zz),
        )

    # --- nodal initial values interpolated to particles
    # (NLPS-Initial-condition-nodes.c) ---
    for icn in find_all(blocks, "Initial-nodal-values"):
        nf = icn.attrs.get("NODES", icn.attrs.get("Nodes"))
        nids = gid2flat[read_node_list(os.path.join(base, str(nf)))]
        vel = parse_vector(str(icn.props.get("VELOCITY", "[0,0,0]")))
        field = np.zeros((n_nodes, d))
        field[nids] = vel[:d]
        # interpolate with the background multilinear basis (the reference
        # interpolates through the FEM background mesh shape functions)
        from ..shapefun import fem

        sf = fem.evaluate(grid, jnp.asarray(pos, config.dtype()))
        sf = sf[0] if isinstance(sf, tuple) else sf
        N = np.asarray(jnp.where(sf["mask"], sf["N"], 0.0))
        vp = np.einsum("pk,pkc->pc", N, np.asarray(field)[np.asarray(sf["node_ids"])])
        particles = particles.replace(v=jnp.asarray(np.asarray(particles.v) + vp))

    # --- gravity ---
    n_curve = max(sp.n_steps, 1)
    gravity = None
    gb = find(blocks, "generate-gravity-field-constant", "GramsBodyForces")
    if gb is not None:
        gravity = np.zeros((n_curve, d))
        for key, val in gb.props.items():
            comp = {"g.x": 0, "g.y": 1, "g.z": 2, "b.x": 0, "b.y": 1, "b.z": 2}.get(key)
            if comp is not None and comp < d:
                gravity[:, comp] = float(val)
        for st in gb.statements:
            comp = {"g.x": 0, "g.y": 1, "g.z": 2}.get(st[0])
            if comp is not None and comp < d and len(st) > 1:
                try:
                    # reference constant form: 'g.x DOUBLE'
                    # (__fill_gravity_constant, Read_Generate_Gravity_Field.c)
                    gravity[:, comp] = float(st[1])
                except ValueError:
                    gravity[:, comp] = read_curve_file(
                        os.path.join(base, st[1]), n_curve
                    )

    # --- Neumann loads ---
    neumann = []
    for nb in find_all(blocks, "Define-Neumann-Boundary", "GramsNeumannBC"):
        ids = read_node_list(os.path.join(base, str(nb.attrs["File"])))
        for st in nb.statements:
            if st[0] not in ("BcNeumann", "T.x", "T.y", "T.z"):
                continue
            if st[0] == "BcNeumann":
                comp = {"T.x": 0, "T.y": 1, "T.z": 2}[st[1]]
                cf = st[2]
            else:
                comp = {"T.x": 0, "T.y": 1, "T.z": 2}[st[0]]
                cf = st[1]
            if cf == "NULL":
                continue
            curve = read_curve_file(os.path.join(base, cf), n_curve)
            neumann.append((ids, comp, curve))

    # --- outputs ---
    out = find(blocks, "GramsOutputs")
    out_dir, out_every = "output", 100
    vtk_fields = None
    backup_every = 0
    if out is not None:
        out_every = int(out.attrs.get("i", out_every))
        out_dir = str(out.props.get("DIR", out.attrs.get("DIR", out_dir)))
        backup_every = int(out.props.get("Out-backup", backup_every))
        from . import vtk as vtk_mod

        vtk_fields = vtk_mod.fields_from_outputs(out.props)

    # --- Event-driven CSV path outputs (NLPS-Out-{particle,nodal}-path-csv.c;
    # Event struct Types.h:872-975) ---
    _CSV_FIELD_MAP = {
        "velocity": "v", "acceleration": "a", "displacement": "dis",
        "stress": "stress", "strain": "eps", "deformation-gradient": "F",
        "damage": "damage", "eps": "eps", "plastic-strain": "eps",
    }
    csv_events = []
    for b in find_all(
        blocks, "Out-particles-path-csv", "Out-particle-path-csv",
        "Out-nodal-path-csv",
        # Gauss-point evolution: per-particle stress/F/EPS time series
        # (reference Gauss_Point_evolution__InOutFun__, WriteCSV.c:126-158;
        # its reader is vestigial there — the block schema mirrors the
        # particle-path events)
        "Out-Gauss-Point-evolution-csv",
    ):
        kind = "nodes" if "nodal" in b.keyword else "particles"
        ids_file = b.props.get("PATH", b.attrs.get("PATH"))
        ids = (
            read_node_list(os.path.join(base, str(ids_file)))
            if ids_file
            else np.arange(0)
        )
        if kind == "nodes" and not unstructured:
            ids = gid2flat[ids]
        fields = [
            _CSV_FIELD_MAP[k[4:].lower()]
            for k, v in b.props.items()
            if k.lower().startswith("out-")
            and str(v).lower() in ("true", "1")
            and k[4:].lower() in _CSV_FIELD_MAP
        ]
        default_fields = (
            ("stress", "F", "eps") if "Gauss" in b.keyword else ("x", "v")
        )
        csv_events.append(
            dict(
                kind=kind,
                ids=np.asarray(ids, np.int64),
                fields=tuple(fields) or default_fields,
                i_start=int(b.attrs.get("i_ini", b.attrs.get("i_start", 0))),
                i_step=max(1, int(b.attrs.get("i_step", 1))),
                i_end=int(b.attrs.get("i_end", sp.n_steps or 1)),
                dir=str(b.props.get("DIR", "output")),
            )
        )

    # --- fracture activation (deck form of --Fracture-Modulus) ---
    fracture = None
    solver_block = find(blocks, "NLPS-Solver", "GramsTime")
    if solver_block is not None:
        fm = solver_block.props.get(
            "Fracture-Modulus", solver_block.attrs.get("Fracture-Modulus")
        )
        if fm is not None:
            fracture = normalize_fracture(str(fm))

    shp, shp_params = _shapefun(blocks)
    if unstructured and shp == "lme":
        # meshfree LME over the unstructured node cloud: attach the
        # support-radius bin grid (femesh.with_node_bins)
        from ..shapefun import lme as lme_mod

        lp = lme_mod.LMEParams(**shp_params)
        grid = femesh.with_node_bins(
            grid, lme_mod.support_radius(lp, grid.h_avg)
        )

    # --- mixtures (soil-water coupling) ---
    mixtures = _mixtures(blocks)
    if mixtures is not None and formulation == "u":
        formulation = "upw"
    if formulation == "upw":
        if mixtures is None:
            raise ValueError("soil-water analysis requires a Define-Mixture block")
        from ..formulations.upw import init_mixture_state

        particles = init_mixture_state(particles, mats, mixtures)
        # only the soil kinds drive the effective-stress update
        kinds = tuple(
            sorted({int(np.asarray(mats.kind)[i]) for i in np.asarray(mixtures.soil_id)})
        )

    return SimulationSetup(
        solver=sp,
        grid=grid,
        particles=particles,
        materials=mats,
        kinds=kinds,
        shapefun=shp,
        shapefun_params=shp_params,
        gravity=gravity,
        dirichlet_nodes=dirichlet_nodes,
        neumann=neumann,
        out_dir=out_dir,
        out_every=out_every,
        backup_every=backup_every,
        vtk_fields=vtk_fields,
        csv_events=csv_events,
        formulation=formulation,
        mixtures=mixtures,
        fracture=fracture,
    )


def normalize_fracture(name: str) -> str:
    """Map the reference's --Fracture-Modulus spellings to our damage-driver
    keys, rejecting unknowns loudly (driver-nl-partsol.c:135-144)."""
    key = name.strip().lower()
    if key in ("eigenerosion", "eigen-erosion"):
        return "eigenerosion"
    if key in ("eigensoftening", "eigen-softening"):
        return "eigensoftening"
    raise ValueError(
        f"Wrong input for Fracture-Modulus ({name!r}): use Eigenerosion or "
        "Eigensoftening"
    )
