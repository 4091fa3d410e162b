"""nlpartsol — Material Point Method framework in JAX.

From-scratch re-design of NL-PartSol (migmolper/NL-PartSol, pure C + PETSc)
for JAX/XLA and Pallas on accelerator device meshes.  See SURVEY.md for the capability
map and BASELINE.md for the tracked performance metrics.
"""

# Importing config pins process-level numerics (solver dtype, and
# full-precision matmul accumulation — reduced-precision passes corrupt the
# F_{n+1} = (I + ∇du)·F_n update; see config.py).
from . import config  # noqa: F401

__version__ = "0.1.0"
