"""Produce the END-TO-END golden trajectory from the reference binary
(BASELINE.md correctness gate at the formulation level).

Pipeline (fully reproducible):
  1. scripts/build_reference_subset.py — builds /tmp/refbuild/nl-partsol:
     the reference WITHOUT PETSc, with a from-scratch row-major LAPACKE
     shim, and with the documented upstream-defect patches applied (this
     reference revision is mid-refactor: the DEM tangent/update stages were
     disconnected, upw had a double free and a stripped body-force field,
     plus two latent under-allocations — see PATCHES there, each with
     file/line provenance).
  2. Runs the committed deck tests/golden/dem_bar/sim.nlp: a 0.6 m bar
     (12x2 Q4 elements, GPxElement=4 Gauss seeding), both ends pinned,
     uniform initial axial velocity 1 m/s, Neo-Hookean E=1e7 nu=0,
     Discrete-Energy-Momentum implicit scheme (dense-LAPACK reduced Newton,
     U-Discrete-Energy-Momentum.c:116), 20 steps at CFL 0.4.
  3. Extracts particle positions/velocities/stress from the VTK outputs at
     steps {0, 5, 10, 15, 19} into tests/golden/dem_bar/trajectory.csv.

Conventions captured in the golden data (asserted by tests/test_reference_e2e.py):
  * Particles_k.vtk is the state AFTER step k (k=0 is one step in).
  * The reference's ChainPtr stack REVERSES element connectivity, so its
    Gauss-point order within an element is a fixed permutation of the
    seeding table order — the test matches particles by position.
  * The STRESS tensor is the DEM scheme's midpoint average-strain SECOND
    PIOLA S(C_mid, J_mid), not a Cauchy/Kirchhoff stress.

Run:  python scripts/build_reference_subset.py && \
      python scripts/make_reference_e2e_golden.py
"""

import os
import re
import shutil
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# deck -> spatial dimension (3D decks run the nl-partsol-3d binary: the
# reference's 2D/3D switch is the compile-time USE_PLAINSTRAIN macro)
DECKS = {"dem_bar": 2, "dem_svk_bar": 2, "dem_bar3d": 3}
RUN = "/tmp/refrun_e2e"
STEPS = (0, 5, 10, 15, 19)


def read_vtk(path):
    txt = open(path).read().splitlines()
    fields = {}
    i = 0
    n = None
    while i < len(txt):
        l = txt[i].strip()
        if l.startswith("POINTS"):
            n = int(l.split()[1])
            vals = []
            i += 1
            while len(vals) < 3 * n:
                vals += [float(v) for v in txt[i].split()]
                i += 1
            fields["x"] = np.array(vals).reshape(n, 3)
            continue
        m = re.match(r"VECTORS (\S+)", l)
        if m:
            vals = []
            i += 1
            while len(vals) < 3 * n:
                vals += [float(v) for v in txt[i].split()]
                i += 1
            fields[m.group(1)] = np.array(vals).reshape(n, 3)
            continue
        m = re.match(r"TENSORS (\S+)", l)
        if m:
            vals = []
            i += 1
            while len(vals) < 9 * n:
                vals += [float(v) for v in txt[i].split()]
                i += 1
            fields[m.group(1)] = np.array(vals).reshape(n, 3, 3)
            continue
        i += 1
    return fields


def make_one(binary, deck_name, dim):
    DECK = os.path.join(REPO, "tests", "golden", deck_name)
    if os.path.exists(RUN):
        shutil.rmtree(RUN)
    shutil.copytree(DECK, RUN, ignore=shutil.ignore_patterns("trajectory.csv"))
    os.makedirs(os.path.join(RUN, "out"), exist_ok=True)
    r = subprocess.run(
        [binary, "--FORMULATION-U", "-f", "sim.nlp"],
        cwd=RUN, capture_output=True, text=True,
    )
    if r.returncode != 0:
        sys.stderr.write(r.stdout[-3000:] + r.stderr[-2000:])
        sys.exit(1)
    rows = []
    for step in STEPS:
        f = read_vtk(os.path.join(RUN, "out", f"Particles_{step}.vtk"))
        x, v, s = f["x"], f["VELOCITY"], f["STRESS"]
        for p in range(x.shape[0]):
            if dim == 2:
                rows.append(
                    [step, p, x[p, 0], x[p, 1], v[p, 0], v[p, 1],
                     s[p, 0, 0], s[p, 0, 1], s[p, 1, 1]]
                )
            else:
                rows.append(
                    [step, p, x[p, 0], x[p, 1], x[p, 2],
                     v[p, 0], v[p, 1], v[p, 2],
                     s[p, 0, 0], s[p, 0, 1], s[p, 0, 2],
                     s[p, 1, 1], s[p, 1, 2], s[p, 2, 2]]
                )
    header = (
        "step,pid,x,y,vx,vy,sxx,sxy,syy" if dim == 2
        else "step,pid,x,y,z,vx,vy,vz,sxx,sxy,sxz,syy,syz,szz"
    )
    out = os.path.join(DECK, "trajectory.csv")
    np.savetxt(
        out, np.array(rows), delimiter=",",
        header=header, comments="", fmt="%.17g",
    )
    print(f"{out}: {len(rows)} rows")


def main():
    if not os.path.exists("/tmp/refbuild/nl-partsol") or not os.path.exists(
        "/tmp/refbuild/nl-partsol-3d"
    ):
        subprocess.run(
            [sys.executable,
             os.path.join(REPO, "scripts", "build_reference_subset.py")],
            check=True,
        )
    for deck_name, dim in DECKS.items():
        binary = "/tmp/refbuild/nl-partsol" + ("-3d" if dim == 3 else "")
        make_one(binary, deck_name, dim)


if __name__ == "__main__":
    main()
