"""END-TO-END head-to-head against the reference binary.

The golden trajectory (tests/golden/dem_bar/trajectory.csv) is the output
of the reference's own Discrete-Energy-Momentum implicit driver — the
dense-LAPACK reduced-Newton path (U-Discrete-Energy-Momentum.c:116,
solve_reducted_system :1550) — compiled WITHOUT PETSc and with documented
upstream-defect patches (scripts/build_reference_subset.py PATCHES), run on
the committed deck tests/golden/dem_bar/sim.nlp and extracted by
scripts/make_reference_e2e_golden.py.

Our side parses the SAME deck, runs the DEM implicit step in float64 with
the reference's average-strain midpoint stress rule, and must agree far
inside the reference's Newton tolerance TOL_NR = 1e-5 (src/Macros.h:40):
positions to 1e-8, velocities to 1e-6, midpoint 2nd-Piola stress to 1e-6
relative — measured agreement is ~1e-11 / 1e-8 / 1e-8.

Runs in a subprocess because float64 mode (jax_enable_x64) must not leak
into the rest of the suite.
"""

import os
import subprocess
import sys

import pytest


@pytest.mark.parametrize("deck", ["dem_bar", "dem_svk_bar", "dem_bar3d"])
def test_dem_matches_reference_binary(deck):
    """Three independent trajectories: Neo-Hookean nu=0 and
    Saint-Venant-Kirchhoff nu=0.3 in 2D, and the 3D H8 bar
    against the nl-partsol-3d binary — the reference's
    never-exercised 3D leg, drivable after six documented mid-refactor
    fixes (TensorLib 3D-branch typos, the U-Analisys [9]->[8] diagonal
    overflow, the 2D-gated initialise_particles, the NULL
    List_Particles_Node push — build_reference_subset.py PATCHES)."""
    worker = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "_e2e_worker.py"
    )
    r = subprocess.run(
        [sys.executable, worker, deck],
        capture_output=True,
        text=True,
        timeout=900,
    )
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    assert "E2E_PARITY_OK" in r.stdout
