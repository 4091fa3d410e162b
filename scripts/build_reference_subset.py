"""Build the reference NL-PartSol binary WITHOUT PETSc (the dense-LAPACK
subset) for end-to-end head-to-head runs (BASELINE.md correctness gate).

What it builds: the full reference tree (driver + InOutFun + Nodes +
Particles + Constitutive + Matlib + Formulations) with

* the two PETSc-SNES formulations (U-Newmark-beta.c, U-Static.c) replaced
  by loud stubs — every other scheme (FE, Generalized-alpha, NPC-FS,
  Discrete-Energy-Momentum, up/upw Newmark via dense LAPACK) compiles;
* tiny petsc*.h stub headers (PetscErrorCode/PetscPrintf/Initialize);
* a from-scratch row-major LAPACKE shim over the image's Fortran
  liblapack.so.3 (LAPACKE_dsyev/dgetrf/dgetrs/dlange/dgecon — the only
  five the tree uses).

Output binary: /tmp/refbuild/nl-partsol
Run:  python scripts/build_reference_subset.py
"""

import os
import shutil
import subprocess
import sys

REF = "/root/reference/nl-partsol"
BUILD = "/tmp/refbuild"

PETSC_STUB = r"""
#ifndef PETSC_STUB_H
#define PETSC_STUB_H
/* Minimal stand-ins so the non-PETSc schemes build (the SNES formulations
   are stubbed out; see build_reference_subset.py). */
#include <stdio.h>
#include <stdarg.h>
#include <stdbool.h>
#include <stdlib.h>
#include <string.h>
typedef int PetscErrorCode;
typedef int MPI_Comm;
#define PETSC_COMM_WORLD 0
#define PETSC_COMM_SELF 0
static inline int PetscInitialize(int *argc, char ***argv, const char *f,
                                  const char *h) {
  (void)argc; (void)argv; (void)f; (void)h; return 0;
}
static inline int PetscFinalize(void) { return 0; }
static inline int PetscPrintf(MPI_Comm c, const char *fmt, ...) {
  (void)c;
  va_list ap;
  va_start(ap, fmt);
  int r = vprintf(fmt, ap);
  va_end(ap);
  fflush(stdout);
  return r < 0;
}
#endif
"""

LAPACKE_SHIM = r"""
#ifndef LAPACKE_SHIM_H
#define LAPACKE_SHIM_H
/* Row-major LAPACKE shim over Fortran LAPACK (liblapack.so.3): implements
   by definition — transpose to column-major, call the Fortran routine,
   transpose back.  Only the five entry points the reference uses. */
#include <stdlib.h>
#include <string.h>

typedef int lapack_int;
#define LAPACK_ROW_MAJOR 101
#define LAPACK_COL_MAJOR 102

extern void dsyev_(const char *jobz, const char *uplo, const int *n,
                   double *a, const int *lda, double *w, double *work,
                   const int *lwork, int *info);
extern void dgetrf_(const int *m, const int *n, double *a, const int *lda,
                    int *ipiv, int *info);
extern void dgetrs_(const char *trans, const int *n, const int *nrhs,
                    const double *a, const int *lda, const int *ipiv,
                    double *b, const int *ldb, int *info);
extern double dlange_(const char *norm, const int *m, const int *n,
                      const double *a, const int *lda, double *work);
extern void dgecon_(const char *norm, const int *n, const double *a,
                    const int *lda, const double *anorm, double *rcond,
                    double *work, int *iwork, int *info);

static void lapacke_shim_transpose(double *a, int m, int n) {
  /* out-of-place transpose of an m x n (row-major) buffer */
  double *t = (double *)malloc(sizeof(double) * (size_t)m * n);
  for (int i = 0; i < m; i++)
    for (int j = 0; j < n; j++)
      t[(size_t)j * m + i] = a[(size_t)i * n + j];
  memcpy(a, t, sizeof(double) * (size_t)m * n);
  free(t);
}

static lapack_int LAPACKE_dsyev(int layout, char jobz, char uplo,
                                lapack_int n, double *a, lapack_int lda,
                                double *w) {
  (void)lda;
  int info = 0, lwork = -1, nn = n;
  double wkopt;
  /* symmetric input: row-major == its column-major transpose */
  dsyev_(&jobz, &uplo, &nn, a, &nn, w, &wkopt, &lwork, &info);
  lwork = (int)wkopt;
  double *work = (double *)malloc(sizeof(double) * (size_t)lwork);
  dsyev_(&jobz, &uplo, &nn, a, &nn, w, work, &lwork, &info);
  free(work);
  /* Fortran stores eigenvectors as columns (col-major);
     LAPACKE row-major stores them as columns of the row-major matrix
     => transpose the output buffer */
  if (layout == LAPACK_ROW_MAJOR && (jobz == 'V' || jobz == 'v') && !info)
    lapacke_shim_transpose(a, n, n);
  return info;
}

static lapack_int LAPACKE_dgetrf(int layout, lapack_int m, lapack_int n,
                                 double *a, lapack_int lda, lapack_int *ipiv) {
  (void)lda;
  int info = 0, mm = m, nn = n;
  if (layout == LAPACK_ROW_MAJOR) lapacke_shim_transpose(a, m, n);
  dgetrf_(&mm, &nn, a, &mm, ipiv, &info);
  if (layout == LAPACK_ROW_MAJOR) lapacke_shim_transpose(a, n, m);
  return info;
}

static lapack_int LAPACKE_dgetrs(int layout, char trans, lapack_int n,
                                 lapack_int nrhs, const double *a,
                                 lapack_int lda, const lapack_int *ipiv,
                                 double *b, lapack_int ldb) {
  (void)lda; (void)ldb;
  int info = 0, nn = n, nr = nrhs;
  double *af = (double *)malloc(sizeof(double) * (size_t)n * n);
  memcpy(af, a, sizeof(double) * (size_t)n * n);
  if (layout == LAPACK_ROW_MAJOR) lapacke_shim_transpose(af, n, n);
  if (layout == LAPACK_ROW_MAJOR && nrhs > 1)
    lapacke_shim_transpose(b, n, nrhs);
  dgetrs_(&trans, &nn, &nr, af, &nn, ipiv, b, &nn, &info);
  if (layout == LAPACK_ROW_MAJOR && nrhs > 1)
    lapacke_shim_transpose(b, nrhs, n);
  free(af);
  return info;
}

static double LAPACKE_dlange(int layout, char norm, lapack_int m,
                             lapack_int n, const double *a, lapack_int lda) {
  (void)lda;
  /* col-major view of a row-major m x n buffer is the n x m transpose:
     one-norm <-> inf-norm swap, 'F'/'M' invariant */
  char nm = norm;
  int mm = m, nn = n;
  if (layout == LAPACK_ROW_MAJOR) {
    if (norm == '1' || norm == 'O' || norm == 'o') nm = 'I';
    else if (norm == 'I' || norm == 'i') nm = '1';
    mm = n; nn = m;
  }
  double *work = (double *)malloc(sizeof(double) * (size_t)(mm > 1 ? mm : 1));
  double r = dlange_(&nm, &mm, &nn, a, &mm, work);
  free(work);
  return r;
}

static lapack_int LAPACKE_dgecon(int layout, char norm, lapack_int n,
                                 const double *a, lapack_int lda,
                                 double anorm, double *rcond) {
  (void)lda;
  /* row-major factors viewed col-major are the factors of A^T:
     cond_1(A) == cond_inf(A^T) */
  char nm = norm;
  if (layout == LAPACK_ROW_MAJOR) {
    if (norm == '1' || norm == 'O' || norm == 'o') nm = 'I';
    else if (norm == 'I' || norm == 'i') nm = '1';
  }
  int info = 0, nn = n;
  double *work = (double *)malloc(sizeof(double) * (size_t)4 * n);
  int *iwork = (int *)malloc(sizeof(int) * (size_t)n);
  dgecon_(&nm, &nn, a, &nn, &anorm, rcond, work, iwork, &info);
  free(work);
  free(iwork);
  return info;
}

#endif
"""

SNES_STUBS = r"""
/* Loud stubs for the PETSc-SNES formulations (not built in this subset). */
#include <stdio.h>
#include <stdlib.h>
#include "Macros.h"
#include "Types.h"

int U_Newmark_Beta(Mesh FEM_Mesh, Particle MPM_Mesh,
                   Time_Int_Params Parameters_Solver) {
  (void)FEM_Mesh; (void)MPM_Mesh; (void)Parameters_Solver;
  fprintf(stderr, "U_Newmark_Beta: PETSc subset not built\n");
  return EXIT_FAILURE;
}

int U_Static(Mesh FEM_Mesh, Particle MPM_Mesh,
             Time_Int_Params Parameters_Solver) {
  (void)FEM_Mesh; (void)MPM_Mesh; (void)Parameters_Solver;
  fprintf(stderr, "U_Static: PETSc subset not built\n");
  return EXIT_FAILURE;
}
"""

PETSC_HEADERS = [
    "petscksp.h", "petscsys.h", "petscsnes.h", "petscistypes.h",
    "petscmat.h", "petscsystypes.h", "petscvec.h", "petscviewerhdf5.h",
]


def main():
    if os.path.exists(BUILD):
        shutil.rmtree(BUILD)
    shutil.copytree(REF, BUILD, ignore=shutil.ignore_patterns("CMakeFiles", ".git"))
    shim = os.path.join(BUILD, "shim")
    os.makedirs(shim, exist_ok=True)
    for h in PETSC_HEADERS:
        open(os.path.join(shim, h), "w").write(PETSC_STUB)
    open(os.path.join(shim, "lapacke.h"), "w").write(LAPACKE_SHIM)
    open(os.path.join(BUILD, "snes_stubs.c"), "w").write(SNES_STUBS)
    apply_patches()

    # U-Newmark-beta.h: PetscErrorCode return + petsc includes -> stubs work
    # via the shim headers; exclude the two SNES .c files from the build.
    sources = []
    for root, _dirs, files in os.walk(os.path.join(BUILD, "src")):
        for f in files:
            if not f.endswith(".c"):
                continue
            if f in ("U-Newmark-beta.c", "U-Static.c", "ksp-PETSC.c"):
                continue
            sources.append(os.path.join(root, f))
    sources.append(os.path.join(BUILD, "driver-nl-partsol.c"))
    sources.append(os.path.join(BUILD, "snes_stubs.c"))

    # Two binaries from the same patched tree: the reference's 2D/3D switch
    # is the COMPILE-TIME macro USE_PLAINSTRAIN (src/Macros.h:31-35), so a
    # 3D run needs its own executable (used by the dem_bar3d e2e gate).
    for out_name, dim_flags in (
        ("nl-partsol", ["-DUSE_PLAINSTRAIN"]),
        ("nl-partsol-3d", []),
    ):
        cmd = (
            ["gcc", "-O2", "-g", "-fcommon", "-D__unix__"] + dim_flags
            + [
             # force the petsc stub into every TU: some headers (U-Static.h)
             # use PetscErrorCode without including a petsc header themselves
             "-include", os.path.join(shim, "petscsys.h"),
             "-I", os.path.join(BUILD, "src"), "-I", shim]
            + sources
            + ["-o", os.path.join(BUILD, out_name),
               "-l:liblapack.so.3", "-l:libblas.so.3", "-lm", "-fopenmp"]
        )
        print(" ".join(cmd[:12]), f"... ({len(sources)} sources)")
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            sys.stderr.write(r.stderr[-8000:])
            sys.exit(1)
        print("built:", os.path.join(BUILD, out_name))


# ---------------------------------------------------------------------------
# Upstream-defect patches (applied to the BUILD COPY only; /root/reference is
# never touched).  This reference revision is mid-refactor: several
# formulation drivers cannot run in ANY environment without these.  Each
# entry is (file, old, new, must_count).
# ---------------------------------------------------------------------------
DEM = "src/Formulations/Displacements/U-Discrete-Energy-Momentum.c"
UPW_NB = "src/Formulations/Displacements-WaterPressure/U-pw-Newmark-beta.c"
UPW_V = "src/Formulations/Displacements-WaterPressure/U-pw-Verlet.c"
P = "/* patched: see build_reference_subset.py */"

PATCHES = [
    # latent 1-byte under-allocation (works only by glibc slack; breaks ASan)
    ("src/InOutFun/Parser.c",
     "malloc((strlen(delims)) * sizeof(char))",
     "malloc((strlen(delims) + 1) * sizeof(char))", 1),
    # Chain nodes allocated pointer-sized (8B) instead of sizeof(Chain) (16B)
    ("src/Matlib/ChainOp.c",
     "malloc(sizeof(ChainPtr))", "malloc(sizeof(Chain))", 3),
    # SVK 2PK stress: trE left uninitialised mid-refactor (its initialiser
    # is commented out on the same line, Saint-Venant-Kirchhoff.c:107) —
    # restore the obvious intent so the SVK material path is drivable
    ("src/Constitutive/Hyperelastic/Saint-Venant-Kirchhoff.c",
     "double trE;// = I1__TensorLib__(E);",
     "double trE = E.N[0][0] + E.N[1][1]"
     " + (NumberDimensions == 3 ? E.N[2][2] : 0.0); " + P,
     1),  # I1 moved to the flat double* API mid-refactor; trace inline
    # symmetrise__TensorLib__ 3D branch uses the old Tensor .N member on a
    # double* (never compiled: only the 2D USE_PLAINSTRAIN build was
    # exercised upstream) — flat-index the obvious intent so the 3D binary
    # links (TensorLib.c:919-926)
    # inverse/transpose-inverse 3D staging blocks: stray ',' and '};'
    # (same never-compiled 3D branch family, TensorLib.c:765-853 — only the
    # 2D USE_PLAINSTRAIN build was exercised upstream)
    ("src/Matlib/TensorLib.c",
     "  A_mT[2] = A[6],", "  A_mT[2] = A[6];", 1),
    ("src/Matlib/TensorLib.c",
     "  A_mT[8] = A[8]};", "  A_mT[8] = A[8];", 1),
    ("src/Matlib/TensorLib.c",
     "A_m1[2] = A[2],", "A_m1[2] = A[2];", 1),
    ("src/Matlib/TensorLib.c",
     "A_m1[8] = A[8]};", "A_m1[8] = A[8];", 1),
    # U-Analisys field allocators, 3D branch: the zz diagonal of the 9-wide
    # row-major tensors is index 8, not 9 — heap overflow on every particle
    # init (ASan-caught; U-Analisys.c:41,71,98; the 2D build never runs it)
    ("src/Formulations/Displacements/U-Analisys.c",
     "Phi.F_n.nM[p][9] = Phi.F_n1.nM[p][9] = Phi.DF.nM[p][9] = 1.0;",
     "Phi.F_n.nM[p][8] = Phi.F_n1.nM[p][8] = Phi.DF.nM[p][8] = 1.0;", 1),
    ("src/Formulations/Displacements/U-Analisys.c",
     "Phi.b_e_n.nM[p][9] = 1.0;", "Phi.b_e_n.nM[p][8] = 1.0;", 1),
    ("src/Formulations/Displacements/U-Analisys.c",
     "Phi.Fbar.nM[p][9] = 0.0;", "Phi.Fbar.nM[p][8] = 0.0;", 1),
    # List_Particles_Node is only allocated when the EigenErosion /
    # EigenSoftening drivers are active (Read_GramsBox.c:131-136); Q4 guards
    # its push accordingly (Q4.c:94-96) but the shared helper used by
    # H8/T3/T4 pushes unconditionally into the NULL table — segfault on any
    # non-fracture 3D run (Particles-Tools.c:89-97)
    ("src/Particles/Particles-Tools.c",
     "  push__SetLib__(&FEM_Mesh.List_Particles_Node[I0], p);\n"
     "  FEM_Mesh.Num_Particles_Node[I0] += 1;",
     "  if ((Driver_EigenErosion == true) || (Driver_EigenSoftening == true)) {\n"
     "    push__SetLib__(&FEM_Mesh.List_Particles_Node[I0], p);\n"
     "    FEM_Mesh.Num_Particles_Node[I0] += 1;\n"
     "  }", 1),
    # particle mass/volume/density initialisation is gated to 2D mid-refactor
    # (Generate-One-Phase-Analysis.c:243-245) — every particle would carry
    # zero mass in 3D; initialise_particles itself is dim-generic (its
    # volume_Element dispatches to volume__H8__/volume__T4__)
    ("src/InOutFun/Analysis/Generate-One-Phase-Analysis.c",
     "    if (Ndim == 2) {\n"
     "      initialise_particles(MPM_GID_Mesh, MPM_Mesh, Msh_Parms.GPxElement);\n"
     "    }",
     "    initialise_particles(MPM_GID_Mesh, MPM_Mesh, Msh_Parms.GPxElement);"
     " " + P, 1),
    # I1__TensorLib__ 3D branch assigns the undeclared I3 (TensorLib.c:120)
    ("src/Matlib/TensorLib.c",
     "    I3 = A[0] + A[4] + A[8];", "    I1 = A[0] + A[4] + A[8];", 1),
    # Inverse_Tensor 3D determinant written for the flat double* API against
    # the Tensor .N[i][j] storage (plus the 'detA.N' typo) — row-major
    # remap A[k] -> A.N[k/3][k%3] (TensorLib.c:270-281)
    ("src/Matlib/TensorLib.c",
     "double detA.N = A.N[0] * A.N[4] * A.N[8] \n"
     "       - A.N[0] * A.N[5] * A.N[7] \n"
     "       + A.N[1] * A.N[5] * A.N[6] \n"
     "       - A.N[1] * A.N[3] * A.N[8] \n"
     "       + A.N[2] * A.N[3] * A.N[7] \n"
     "       - A.N[2] * A.N[4] * A.N[6];",
     "double detA = A.N[0][0] * A.N[1][1] * A.N[2][2] \n"
     "       - A.N[0][0] * A.N[1][2] * A.N[2][1] \n"
     "       + A.N[0][1] * A.N[1][2] * A.N[2][0] \n"
     "       - A.N[0][1] * A.N[1][0] * A.N[2][2] \n"
     "       + A.N[0][2] * A.N[1][0] * A.N[2][1] \n"
     "       - A.N[0][2] * A.N[1][1] * A.N[2][0];", 1),
    ("src/Matlib/TensorLib.c",
     "  symA.N[0] = A.N[0];\n"
     "  symA.N[1] = symA.N[3] = 0.5 * (A.N[1] + A.N[3]);\n"
     "  symA.N[2] = symA.N[6] = 0.5 * (A.N[2] + A.N[6]);\n"
     "  symA.N[4] = A.N[4];\n"
     "  symA.N[5] = symA.N[7] = 0.5 * (A.N[5] + A.N[7]);\n"
     "  symA.N[8] = A.N[8];",
     "  symA[0] = A[0];\n"
     "  symA[1] = symA[3] = 0.5 * (A[1] + A[3]);\n"
     "  symA[2] = symA[6] = 0.5 * (A[2] + A[6]);\n"
     "  symA[4] = A[4];\n"
     "  symA[5] = symA[7] = 0.5 * (A[5] + A[7]);\n"
     "  symA[8] = A[8];", 1),
    # genuine double free: free(nV) then free__MatrixLib__ frees nV again
    (UPW_NB,
     "  free(Effective_Mass.nV);\n  free(IPIV);\n  free__MatrixLib__(Effective_Mass);",
     "  free(IPIV);\n  free__MatrixLib__(Effective_Mass); " + P, 1),
    # Particle.b (body force) was removed upstream mid-refactor; the upw
    # formulations still read it (commented out -> uninitialised Tensor).
    # Zero body force is the only semantics this revision can have.
    (UPW_NB, "//    b_p = MPM_Mesh.b;",
     "    b_p = alloc__TensorLib__(1); " + P, 2),
    (UPW_V, "//    b_p = MPM_Mesh.b;",
     "    b_p = alloc__TensorLib__(1); " + P, 1),
    # --- DEM (U-Discrete-Energy-Momentum): reconnect the update stage that
    # was disconnected when compute-Strains/Nodes-Tools moved to the flat
    # double* API.  All callee functions still exist; only call-site
    # adaptation is needed. ---
    (DEM, "//    J_p = I3__TensorLib__(F_n12_p);",
     "    J_p = F_n12_p.N[0][0] * F_n12_p.N[1][1] - F_n12_p.N[0][1] * F_n12_p.N[1][0]; " + P, 1),
    (DEM,
     "//        C_AB = compute_stiffness_density(GRADIENT_pA, GRADIENT_pB, F_n12_p, J_p, MatProp_p);",
     "        C_AB = compute_stiffness_density(GRADIENT_pA, GRADIENT_pB, F_n12_p, J_p, MatProp_p); " + P, 1),
    (DEM,
     """/*
static Tensor compute_stiffness_density(Tensor GRADIENT_pA, Tensor GRADIENT_pB,
                                        Tensor F_p, double J_p,
                                        Material MatProp_p) {""",
     """/* patched: definition reconnected */
static Tensor compute_stiffness_density(Tensor GRADIENT_pA, Tensor GRADIENT_pB,
                                        Tensor F_p, double J_p,
                                        Material MatProp_p) {""", 1),
    (DEM,
     "  return C_AB;\n}\n*/\n/**************************************************************/\n\nstatic Tensor compute_Nodal_Tangent_Stiffness_Material",
     "  return C_AB;\n}\n\n/**************************************************************/\n\nstatic Tensor compute_Nodal_Tangent_Stiffness_Material", 1),
    (DEM,
     "static Tensor compute_Nodal_Tangent_Stiffness_Material(Tensor, Tensor, Tensor);",
     "static Tensor compute_stiffness_density(Tensor, Tensor, Tensor, double, Material);\nstatic Tensor compute_Nodal_Tangent_Stiffness_Material(Tensor, Tensor, Tensor);", 1),
    # reduced Newton system: Order -> Order_FF (the declared-but-unused
    # variable shows the intent) and the reduced rhs Residual_F
    (DEM,
     "INFO = LAPACKE_dgetrf(LAPACK_ROW_MAJOR,Order,Order,K_Global_FF.nV,LDA,IPIV);",
     "INFO = LAPACKE_dgetrf(LAPACK_ROW_MAJOR,Order_FF,Order_FF,K_Global_FF.nV,LDA,IPIV); " + P, 1),
    (DEM,
     "INFO = LAPACKE_dgetrs(LAPACK_ROW_MAJOR,'T',Order,NRHS, K_Global_FF.nV, LDA,IPIV,Residual.nV,LDB);",
     "INFO = LAPACKE_dgetrs(LAPACK_ROW_MAJOR,'T',Order_FF,NRHS, K_Global_FF.nV, LDA,IPIV,Residual_F.nV,LDB); " + P, 1),
    # stress-integration body: reconnect + flat-API I3 adaptation
    (DEM,
     """/*
Tensor average_strain_integration_Stress__Particles__(Tensor S_p, Tensor F_n1_p,
                                                      Tensor F_n_p,
                                                      Material MatProp_p) {""",
     """/* patched: body reconnected */
static double _det2(Tensor F) { return F.N[0][0]*F.N[1][1] - F.N[0][1]*F.N[1][0]; }
Tensor average_strain_integration_Stress__Particles__(Tensor S_p, Tensor F_n1_p,
                                                      Tensor F_n_p,
                                                      Material MatProp_p) {""", 1),
    (DEM,
     "    double J_n12_p = 0.5 * (I3__TensorLib__(F_n_p) + I3__TensorLib__(F_n1_p));",
     "    double J_n12_p = 0.5 * (_det2(F_n_p) + _det2(F_n1_p)); " + P, 1),
    (DEM,
     "  return S_p;\n}\n\n*/\n/**************************************************************/\n\n/*\n  Auxiliar functions\n*/",
     "  return S_p;\n}\n\n/**************************************************************/\n\n/*\n  Auxiliar functions\n*/", 1),
    (DEM,
     "//Tensor average_strain_integration_Stress__Particles__(Tensor, Tensor, Tensor, Material);",
     "Tensor average_strain_integration_Stress__Particles__(Tensor, Tensor, Tensor, Material); " + P, 1),
    # update stages: get_set_field moved to flat out-param API
    (DEM,
     "//    D_Displacement_Ap =\n//        get_set_field__MeshTools__(D_Displacement, Nodes_p, ActiveNodes);",
     "    D_Displacement_Ap = allocZ__MatrixLib__(Nodes_p.NumberNodes,\n                                            NumberDimensions); " + P + "\n    get_set_field__MeshTools__(D_Displacement_Ap.nV, D_Displacement.nV,\n                               Nodes_p, ActiveNodes);", 2),
    (DEM,
     "//    update_increment_Deformation_Gradient__Particles__(DF_p, D_Displacement_Ap,\n//                                                       gradient_p);",
     "    update_increment_Deformation_Gradient__Particles__(\n        MPM_Mesh.Phi.DF.nM[p], D_Displacement_Ap.nV, gradient_p.nV,\n        Nodes_p.NumberNodes); " + P, 1),
    (DEM,
     "//    update_Deformation_Gradient_n1__Particles__(F_n1_p, F_n_p, DF_p);",
     "    update_Deformation_Gradient_n1__Particles__(\n        MPM_Mesh.Phi.F_n1.nM[p], MPM_Mesh.Phi.F_n.nM[p],\n        MPM_Mesh.Phi.DF.nM[p]); " + P, 1),
    (DEM,
     "//    S_p = average_strain_integration_Stress__Particles__(S_p, F_n1_p, F_n_p,\n//                                                         MatProp_p);",
     "    S_p = average_strain_integration_Stress__Particles__(S_p, F_n1_p, F_n_p,\n                                                         MatProp_p); " + P, 1),
    (DEM,
     "//    Delta_J_p = I3__TensorLib__(DF_p);",
     "    Delta_J_p = DF_p.N[0][0]*DF_p.N[1][1] - DF_p.N[0][1]*DF_p.N[1][0]; " + P, 1),
]


def apply_patches():
    for rel, old, new, count in PATCHES:
        path = os.path.join(BUILD, rel)
        s = open(path).read()
        n = s.count(old)
        if n != count:
            raise RuntimeError(f"patch mismatch in {rel}: found {n}, expected {count}\n{old[:80]}")
        open(path, "w").write(s.replace(old, new))
    print(f"applied {len(PATCHES)} upstream-defect patches")


if __name__ == "__main__":
    main()
