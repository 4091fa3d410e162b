"""Material parameter table.

Replaces the reference's ``Material`` struct (~45 scalar params + string
selectors, /root/reference/nl-partsol/src/Types.h:335-460) with a
struct-of-arrays table indexed by ``Particles.mat_id``: every parameter is an
``(Nmat,)`` array so per-particle parameter lookup is a gather that fuses
into the constitutive kernels.  Model dispatch is by integer ``kind`` instead
of string compare (Constitutive.c:28-255).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax.numpy as jnp
from ..utils import struct

from .. import config

# Model kind codes (the reference's Type strings, Constitutive.c:28-255)
SOLID_RIGID = 0
LINEAR_ELASTIC = 1
SAINT_VENANT_KIRCHHOFF = 2
NEO_HOOKEAN = 3  # "Neo-Hookean-Wriggers"
HENCKY = 4
NEWTONIAN_FLUID = 5  # "Newtonian-Fluid-Compressible"
VON_MISES = 6
DRUCKER_PRAGER = 7
MATSUOKA_NAKAI = 8
LADE_DUNCAN = 9
# carried-but-unwired in the reference; wired here:
MODIFIED_LADE_DUNCAN = 10  # Modified-Lade-Duncan.c:188 (full impl, no dispatch)
BINGHAM_FLUID = 11  # Bingham-Fluid.c (body commented out; completed here)
MOONEY_RIVLIN = 12  # Mooney-Rivlin.c:17-40 (stub energy; completed here)

KIND_NAMES = {
    "Solid-Rigid": SOLID_RIGID,
    "LE": LINEAR_ELASTIC,
    "Linear-Elastic": LINEAR_ELASTIC,
    "Saint-Venant-Kirchhoff": SAINT_VENANT_KIRCHHOFF,
    "Neo-Hookean-Wriggers": NEO_HOOKEAN,
    "Hencky": HENCKY,
    "Newtonian-Fluid-Compressible": NEWTONIAN_FLUID,
    "Von-Mises": VON_MISES,
    "Drucker-Prager": DRUCKER_PRAGER,
    "Matsuoka-Nakai": MATSUOKA_NAKAI,
    "Lade-Duncan": LADE_DUNCAN,
    "Modified-Lade-Duncan": MODIFIED_LADE_DUNCAN,
    "Bingham-Fluid": BINGHAM_FLUID,
    "Mooney-Rivlin": MOONEY_RIVLIN,
}


@struct.dataclass
class MaterialTable:
    """(Nmat,)-array-per-parameter material table."""

    kind: jnp.ndarray  # int32 model code
    rho0: jnp.ndarray  # reference density
    E: jnp.ndarray  # Young modulus
    nu: jnp.ndarray  # Poisson ratio
    # Plasticity (Von-Mises / Drucker-Prager / Borja family)
    kappa0: jnp.ndarray  # reference yield stress / hardening ref (kappa_0)
    hardening_modulus: jnp.ndarray
    # Voce saturation hardening (Von-Mises; Types.h:432-437)
    theta_voce: jnp.ndarray
    K0_voce: jnp.ndarray
    Kinf_voce: jnp.ndarray
    delta_voce: jnp.ndarray
    # Ortiz power hardening (Drucker-Prager; Types.h:426-428)
    exponent_ortiz: jnp.ndarray
    plastic_strain_0: jnp.ndarray
    # Drucker-Prager friction/dilatancy/cohesion
    cohesion: jnp.ndarray
    friction_angle: jnp.ndarray  # degrees
    dilatancy_angle: jnp.ndarray  # degrees
    atmospheric_pressure: jnp.ndarray
    J2_degradated: jnp.ndarray
    # Borja (2003) frictional family (Types.h:406-412)
    m_frictional: jnp.ndarray
    c0_frictional: jnp.ndarray
    phi_frictional: jnp.ndarray
    psi_frictional: jnp.ndarray
    a1_borja: jnp.ndarray
    a2_borja: jnp.ndarray
    a3_borja: jnp.ndarray
    alpha_borja: jnp.ndarray
    # Fluid
    viscosity: jnp.ndarray
    n_macdonald: jnp.ndarray
    compressibility: jnp.ndarray  # Cel-derived bulk for fluids
    reference_pressure: jnp.ndarray
    # Bingham regularisation (Papanastasiou): mu = mu0 + tau_y/g*(1-e^-m g)
    # (Bingham-Fluid.c compute_Bingham_viscosity; tau_y rides kappa0)
    fluidity_param: jnp.ndarray
    # Mooney-Rivlin deviatoric moduli (reference mu_Ogden[0..1],
    # Mooney-Rivlin.c:22-23)
    mu1_mr: jnp.ndarray
    mu2_mr: jnp.ndarray
    # Fracture: eigenerosion / eigensoftening (Types.h:382-391)
    Ceps: jnp.ndarray
    Gf: jnp.ndarray
    ft: jnp.ndarray
    heps: jnp.ndarray
    wcrit: jnp.ndarray
    # F-bar locking control
    alpha_fbar: jnp.ndarray

    @property
    def count(self) -> int:
        return self.kind.shape[0]

    def kinds_present(self) -> tuple:
        """Static set of model codes in the table (requires concrete array)."""
        import numpy as np

        return tuple(sorted(set(np.asarray(self.kind).tolist())))


_DEFAULTS = dict(
    kind=NEO_HOOKEAN,
    rho0=1000.0,
    E=1e7,
    nu=0.3,
    kappa0=0.0,
    hardening_modulus=0.0,
    theta_voce=1.0,
    K0_voce=0.0,
    Kinf_voce=0.0,
    delta_voce=0.0,
    exponent_ortiz=1.0,
    plastic_strain_0=0.0,
    cohesion=0.0,
    friction_angle=30.0,
    dilatancy_angle=30.0,
    atmospheric_pressure=0.0,
    J2_degradated=0.0,
    m_frictional=0.0,
    c0_frictional=0.0,
    phi_frictional=30.0,
    psi_frictional=30.0,
    a1_borja=0.0,
    a2_borja=0.0,
    a3_borja=0.0,
    alpha_borja=0.0,
    viscosity=1e-3,
    n_macdonald=1.0,
    compressibility=0.0,
    reference_pressure=0.0,
    fluidity_param=100.0,
    mu1_mr=0.0,
    mu2_mr=0.0,
    Ceps=1.0,
    Gf=0.0,
    ft=0.0,
    heps=0.0,
    wcrit=0.0,
    alpha_fbar=0.0,
)


def material(**kw) -> dict:
    """One material row; unknown keys rejected, missing keys defaulted.
    ``kind`` may be a reference Type string or an int code."""
    bad = set(kw) - set(_DEFAULTS)
    if bad:
        raise ValueError(f"unknown material parameters: {sorted(bad)}")
    row = dict(_DEFAULTS)
    row.update(kw)
    if isinstance(row["kind"], str):
        row["kind"] = KIND_NAMES[row["kind"]]
    return row


def material_table(rows: Sequence[dict]) -> MaterialTable:
    dt = config.dtype()
    cols = {}
    for name in _DEFAULTS:
        vals = [r[name] for r in rows]
        cols[name] = jnp.asarray(vals, jnp.int32 if name == "kind" else dt)
    return MaterialTable(**cols)


def lame_parameters(E, nu):
    """(lambda, G) from (E, nu) as used throughout the reference models."""
    G = E / (2.0 * (1.0 + nu))
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    return lam, G


def bulk_shear(E, nu):
    K = E / (3.0 * (1.0 - 2.0 * nu))
    G = E / (2.0 * (1.0 + nu))
    return K, G
