"""Global numerical configuration of the MPM framework.

The reference solver (NL-PartSol) runs everything in float64 on CPU
(``/root/reference/nl-partsol/src/Types.h``).  Here the solver dtype is a
process-level switch:

* ``float32`` (default) — the production dtype on the GPU.
* ``float64`` — opt-in for verification runs against the reference
  tolerances (requires ``JAX_ENABLE_X64=1`` / ``jax.config.update``).  The
  GPU runs float64 natively, at a fraction of the float32 rate; its speed
  there has not been measured.

All kernels read :func:`dtype` / :func:`index_dtype` at *trace* time, so a
process picks one dtype per jitted program.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

_DTYPE_NAME = os.environ.get("NLPS_DTYPE", "float32")


def set_dtype(name: str) -> None:
    """Set the solver scalar dtype ('float32' or 'float64').

    float64 additionally requires x64 mode, which this enables.
    """
    global _DTYPE_NAME
    if name not in ("float32", "float64"):
        raise ValueError(f"unsupported solver dtype: {name}")
    if name == "float64":
        jax.config.update("jax_enable_x64", True)
    _DTYPE_NAME = name


def dtype() -> jnp.dtype:
    return jnp.dtype(_DTYPE_NAME)


def index_dtype() -> jnp.dtype:
    return jnp.dtype(jnp.int32)


if _DTYPE_NAME == "float64":  # honour env var at import
    jax.config.update("jax_enable_x64", True)

# On the GPU, float32 matmuls/einsums may run in TF32 (a 10-bit mantissa,
# ~3 decimal digits).  The MPM kinematics update F_{n+1} = (I + ∇du)·F_n
# where ∇du is O(1e-4): in TF32 the product rounds straight back to F_n and
# the solver silently computes rigid motion.  Pin full float32 precision for
# every dot/einsum; hot code that can tolerate lower precision must opt in
# explicitly (jax.default_matmul_precision context).
jax.config.update("jax_default_matmul_precision", "highest")

# Numerical tolerances mirroring the reference's gates
# (/root/reference/nl-partsol/src/Macros.h:40 TOL_NR = 1e-5;
#  src/Globals.h:57 TOL_Radial_Returning; src/Nodes/LME.c rcond guard 1e-8).
TOL_NR = 1e-5
TOL_LME = 1e-10
RCOND_GUARD = 1e-8
