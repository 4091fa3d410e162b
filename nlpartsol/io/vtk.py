"""Legacy ASCII VTK writers (ParaView-compatible).

Reference: /root/reference/nl-partsol/src/InOutFun/Outputs/WriteVtk.c —
particle cloud with toggleable fields (velocity, acceleration, displacement,
stress + eigenvalues, Von-Mises stress, deformation gradient, J, EPS, damage,
energy, mass, density; toggles in Types.h:955-973) and the nodal mesh with
reactions.

Writes one file per output step: ``<dir>/<base>_<step>.vtk``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..ops import tensor as tn
from ..types import Grid, Particles

_DEFAULT_FIELDS = (
    "velocity",
    "acceleration",
    "displacement",
    "stress",
    "von_mises",
    "J",
    "eps",
    "damage",
    "W",
    "mass",
    "density",
)


def _vec3(a: np.ndarray) -> np.ndarray:
    """Pad (n, d) to (n, 3) — VTK points/vectors are 3D."""
    n, d = a.shape
    out = np.zeros((n, 3))
    out[:, :d] = a
    return out


def _header(fh, title: str):
    fh.write("# vtk DataFile Version 3.0\n")
    fh.write(f"{title}\n")
    fh.write("ASCII\n")


def _write_array(fh, a: np.ndarray, fmt="%.6e"):
    np.savetxt(fh, a, fmt=fmt)


def von_mises_stress(stress: np.ndarray, stress_zz: np.ndarray) -> np.ndarray:
    """σ_vm from the (d,d) block + plane-strain zz channel."""
    n, d, _ = stress.shape
    s3 = np.zeros((n, 3, 3))
    s3[:, :d, :d] = stress
    if d == 2:
        s3[:, 2, 2] = stress_zz
    p = np.trace(s3, axis1=1, axis2=2) / 3.0
    dev = s3 - p[:, None, None] * np.eye(3)
    return np.sqrt(1.5 * np.sum(dev * dev, axis=(1, 2)))


def write_particles_vtk(
    path: str,
    p: Particles,
    fields: tuple = _DEFAULT_FIELDS,
) -> str:
    """Particle cloud as VTK POLYDATA vertices with point data
    (particle_results_vtk__InOutFun__ equivalent, WriteVtk.c:53-100)."""
    act = np.asarray(p.active)
    order = np.argsort(np.asarray(p.pid)[act])

    def g(a):
        return np.asarray(a)[act][order]

    x = _vec3(g(p.x))
    n = x.shape[0]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        _header(fh, "nlpartsol particles")
        fh.write("DATASET POLYDATA\n")
        fh.write(f"POINTS {n} float\n")
        _write_array(fh, x)
        fh.write(f"VERTICES {n} {2 * n}\n")
        _write_array(fh, np.stack([np.ones(n, int), np.arange(n)], -1), fmt="%d")
        fh.write(f"POINT_DATA {n}\n")
        if "velocity" in fields:
            fh.write("VECTORS velocity float\n")
            _write_array(fh, _vec3(g(p.v)))
        if "acceleration" in fields:
            fh.write("VECTORS acceleration float\n")
            _write_array(fh, _vec3(g(p.a)))
        if "displacement" in fields:
            fh.write("VECTORS displacement float\n")
            _write_array(fh, _vec3(g(p.dis)))
        if "stress" in fields:
            d = p.dim
            s = g(p.stress)
            s3 = np.zeros((n, 3, 3))
            s3[:, :d, :d] = s
            if d == 2:
                s3[:, 2, 2] = g(p.stress_zz)
            fh.write("TENSORS stress float\n")
            _write_array(fh, s3.reshape(n, 9))
        if "von_mises" in fields:
            fh.write("SCALARS von_mises float 1\nLOOKUP_TABLE default\n")
            _write_array(fh, von_mises_stress(g(p.stress), g(p.stress_zz))[:, None])
        if "stress_eigenvalues" in fields:
            # principal Kirchhoff stresses (Out_EigenValues_Stress toggle)
            d = p.dim
            s = g(p.stress)
            s3 = np.zeros((n, 3, 3))
            s3[:, :d, :d] = 0.5 * (s + np.swapaxes(s, 1, 2))
            if d == 2:
                s3[:, 2, 2] = g(p.stress_zz)
            ev = np.linalg.eigvalsh(s3)[:, ::-1]
            fh.write("VECTORS stress_eigenvalues float\n")
            _write_array(fh, ev)
        if "deformation_gradient" in fields:
            d = p.dim
            F = g(p.F)
            F3 = np.tile(np.eye(3), (n, 1, 1))
            F3[:, :d, :d] = F
            fh.write("TENSORS deformation_gradient float\n")
            _write_array(fh, F3.reshape(n, 9))
        if "green_lagrange" in fields:
            # E = ½(FᵀF − I) (reference compute-Strains.c:434)
            d = p.dim
            F = g(p.F)
            E = 0.5 * (np.einsum("pki,pkj->pij", F, F) - np.eye(d))
            E3 = np.zeros((n, 3, 3))
            E3[:, :d, :d] = E
            fh.write("TENSORS green_lagrange float\n")
            _write_array(fh, E3.reshape(n, 9))
        for name, arr in (
            ("J", p.J),
            ("eps", p.eps),
            ("kappa", p.kappa),
            ("damage", p.damage),
            ("W", p.W),
            ("mass", p.mass),
            ("density", p.rho),
        ):
            if name in fields:
                fh.write(f"SCALARS {name} float 1\nLOOKUP_TABLE default\n")
                _write_array(fh, g(arr)[:, None])
        if "volume" in fields:
            fh.write("SCALARS volume float 1\nLOOKUP_TABLE default\n")
            _write_array(fh, (g(p.vol0) * np.maximum(g(p.J), 0.0))[:, None])
        if "kinetic_energy" in fields:
            ke = 0.5 * g(p.mass) * np.sum(g(p.v) ** 2, axis=1)
            fh.write("SCALARS kinetic_energy float 1\nLOOKUP_TABLE default\n")
            _write_array(fh, ke[:, None])
    return path


#: every supported particle field (WriteVtk.c exposes ~20 toggles,
#: Types.h:955-973; map .nlp Out-* keys through FIELD_ALIASES below)
ALL_FIELDS = _DEFAULT_FIELDS + (
    "stress_eigenvalues",
    "deformation_gradient",
    "green_lagrange",
    "kappa",
    "volume",
    "kinetic_energy",
)

#: reference GramsOutputs toggle name → field name here
FIELD_ALIASES = {
    "vel": "velocity",
    "acc": "acceleration",
    "dis": "displacement",
    "stress": "stress",
    "eigenvalues-stress": "stress_eigenvalues",
    "von-mises": "von_mises",
    "deformation-gradient": "deformation_gradient",
    "green-lagrange": "green_lagrange",
    "plastic-strain": "eps",
    "kappa": "kappa",
    "damage": "damage",
    "energy": "W",
    "kinetic-energy": "kinetic_energy",
    "mass": "mass",
    "density": "density",
    "volume": "volume",
    "jacobian": "J",
}


def fields_from_outputs(props: dict) -> tuple:
    """GramsOutputs ``Out-<name> = true/false`` toggles → field tuple
    (defaults when no Out- keys are present)."""
    toggles = {
        k[4:].lower(): str(v).lower() in ("true", "1", "yes")
        for k, v in props.items()
        if k.lower().startswith("out-")
    }
    if not toggles:
        return _DEFAULT_FIELDS
    out = []
    for key, on in toggles.items():
        name = FIELD_ALIASES.get(key, key.replace("-", "_"))
        if on and name in ALL_FIELDS and name not in out:
            out.append(name)
    # Out- keys present but all false means OFF — the reference writes only
    # the toggled fields (WriteVtk.c:53-100), never a default fallback set
    return tuple(out)


def write_grid_vtk(
    path: str,
    grid: Grid,
    point_data: Optional[dict] = None,
) -> str:
    """Background grid as VTK STRUCTURED_POINTS with optional nodal fields
    (e.g. reactions — the nodal mesh output of WriteVtk.c)."""
    dims = grid.dims
    d = grid.dim
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        _header(fh, "nlpartsol grid")
        fh.write("DATASET STRUCTURED_POINTS\n")
        dd = tuple(dims) + (1,) * (3 - d)
        # VTK is x-fastest; our flat index is C-order (last axis fastest) —
        # arrays below are transposed accordingly.
        fh.write(f"DIMENSIONS {dd[0]} {dd[1]} {dd[2]}\n")
        oo = tuple(grid.origin) + (0.0,) * (3 - d)
        fh.write(f"ORIGIN {oo[0]} {oo[1]} {oo[2]}\n")
        fh.write(f"SPACING {grid.spacing} {grid.spacing} {grid.spacing}\n")
        n = grid.n_nodes
        fh.write(f"POINT_DATA {n}\n")
        for name, arr in (point_data or {}).items():
            a = np.asarray(arr)
            # reorder C-order (last axis fastest) to VTK x-fastest
            if a.ndim == 1:
                a_grid = a.reshape(dims)
                a_out = a_grid.transpose(tuple(reversed(range(d)))).reshape(-1, 1)
                fh.write(f"SCALARS {name} float 1\nLOOKUP_TABLE default\n")
                _write_array(fh, a_out)
            else:
                a_grid = a.reshape(dims + (a.shape[-1],))
                perm = tuple(reversed(range(d))) + (d,)
                a_out = _vec3(a_grid.transpose(perm).reshape(-1, a.shape[-1]))
                fh.write(f"VECTORS {name} float\n")
                _write_array(fh, a_out)
    return path
