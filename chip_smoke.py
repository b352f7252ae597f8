#!/usr/bin/env python3
"""Smoke run of petsc_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py                # every phase below
    python3 chip_smoke.py --phase dist   # the build, then phase dist alone

Phases, one JSON line each on stdout:
  device   the card's name and its nvidia-smi name and power limit;
  build    builds the kernels from petsc_tpu_torch/csrc (and, beside
           them, the earlier designs of earlier_kernels/ that phases
           gamg_grid, gmres_ilu, ex56, maij_kaij and pc time the new ones
           against) and runs
           the one-launch probe (K1), then builds the native host library
           (graphops.cpp, g++), each with its seconds;
  kernels  holds every kernel against its plain PyTorch version on the
           card (f64 to 1e-12, f32 to 1e-5 relative) at n = 2^24+37 and
           n = 128^3, and against a scipy CSR product at 24^3; S1 at 128^3,
           box and star, f64 and f32, on both of its load paths (x aligned:
           the TMA ring; x one element past a 16-byte edge: the cp.async
           ring), each equal to its plain version bit for bit and timed,
           with its launch plan, design and share of the bound in its
           row; times each kernel, its plain version
           and, where one exists, the one PyTorch call that computes the
           same function (CUDA events, median of 20 launches, each after
           the clean L2 flush of L2Flush and with the card held 0.1 ms so
           that the host's launch stays outside the events), and beside K4
           torch.dot(x, y), which reads the same bytes (a yardstick for
           the bytes, not the same function); computes each bound from the
           bytes and flops the function needs;
  flush    K2, torch.add, K3, K4, torch.dot and S1 (box) at 128^3 in f64
           and f32, each timed after the clean flush and after the
           write-only flush that it replaced, in turns;
  solve    the main path: init(), build_dnd((128,)*3, "box"), as_mat and
           CG with -pc_type jacobi to rtol 1e-8 (b = 1, x = 0), with every
           kernel's launch count set to 0 just before and read just after;
           asserts 184 iterations, CONVERGED_RTOL, relres <= 1e-8 and a
           true residual <= 1e-7, and that every CG step went through the
           kernels; then times warm solves and repeats with -pc_type none;
  profile  one warm CG+Jacobi solve under torch.profiler (between two runs
           of spin kernels, about 20 ms each, since the profiler drops the
           card's first events, the more the longer the process has run;
           a spin must be seen on each side): the card's busy
           time, its share of the warm solve time, time by kernel, and the
           µs per launch of K2, K3, K4, S1 and S2 inside the solve (vectors
           warm in L2); asserts that the only second passes (sum_partials)
           are K3's, one per iteration, so K4 is one launch;
  gather   the four gather kernels K5-K8 at the Pallas probes' shapes, f64
           and f32, each equal to its plain version bit for bit on values
           unique per entry, timed on the probes' own values beside the
           plain version and one PyTorch call (take_along_dim,
           index_select, flat indexing, take); the bound counts the
           indices, the output and the distinct input entries read (K8:
           the 32-byte sectors of its input read);
  aij      the assembled-matrix path: the same 128^3 box27 operator as COO
           triplets in bench_kspsolve's order (diagonal first, then the 26
           offsets), through MatAIJ setPreallocationCOO/setValuesCOO, then
           CG+Jacobi to rtol 1e-8, with every launch count set to 0 just
           before the assembly and read just after the solve; asserts kind
           aij_csr, nnz 55,742,968, 184 iterations, CONVERGED_RTOL, relres
           <= 1e-8, a true residual <= 1e-7, a residual history equal to
           the stencil path's to 1e-6 relative, and launches of gather >= 2,
           csr_spmv >= its, const_stencil == 0; times warm solves (jacobi
           and none); holds the assembled values and diagonal against
           v[perm] and csr_vals[diag_pos], and K8 against its plain version
           bit for bit at those two shapes, timed there (K8's row in the
           kernel table is the v[perm] shape's); then the CSR SpMV S2 alone
           at 128^3 against its plain version (f64 1e-12, f32 1e-5) and
           torch.sparse_csr_tensor, with its tile length, Gnnz/s and share
           of the bound in each type, against scipy (the tests/data
           fixtures and 24^3, 1e-12), and on rows cut around its tiles
           (T - 1, T, T + 1 entries across tile edges, a row of 50 T, runs
           of empty rows, entries that end on a tile edge, no entries, and
           vals/col one element past a 16-byte edge) against its plain
           version with equal bits on reruns; the host seconds of the two
           assembly calls on a line of their own;
  aij_profile  the profile phase for one warm CSR CG+Jacobi solve;
  mg       CG + PCMG on that assembled matrix through the user's entry
           points (init with -pc_type mg, KSP, the PCMG API's setLevels and
           setInterpolation with the Q1 hierarchy 128 -> ... -> 8 built here
           with scipy), every launch count set to 0 just before init and read
           just after the solve; asserts the reference's 10 iterations,
           CONVERGED_RTOL, relres <= 1e-8, its residual history (MG_HIST,
           1e-6 relative), each Galerkin level's nnz, a true residual no worse
           than 10x the reference's, and the launches of mg_launches_needed
           (C1 exactly 4 x (levels - 1) per PC application, const_stencil 0);
           reports the host set-up seconds by part and the warm solve, and
           holds S2 on each level's A, P and R against its plain version in
           float64 (1e-12), each timed; then the same with -pc_mg_dtype
           single and a hierarchy of its own (history to 1e-4, S2 in
           float32 to 1e-5), and C1 against
           its plain version in both modes (f64 1e-12, f32 1e-5) at 128^3 and
           2^24 + 37, timed after the clean flush;
  mg_profile  the profile phase for one warm CG+PCMG solve (f64 cycle),
           with the time and µs per launch of S2, C1, K2-K4 and lu_solve;
  gamg     CG + GAMG (smoothed aggregation, every GAMG option at its
           default) on that assembled matrix through the user's entry points
           (init with -pc_type gamg, KSP), every launch count set to 0 just
           before init and read just after the solve; asserts the reference's
           9 iterations, CONVERGED_RTOL, relres <= 1e-8, its residual history
           (GAMG_HIST, 1e-6), the hierarchy (rows, nnz of A and P and the
           aggregate count per level, the SHA-256 of the level-0 aggregates,
           each Chebyshev bound to 1e-12), a true residual no worse than 10x
           the reference's and the launches of mg_launches_needed; reports the
           host set-up seconds by event and the warm solve, and holds S2 on
           each level's A, P and R against float64, each timed; then the same
           with -pc_mg_dtype single (history to 1e-4);
  gamg_profile  the profile phase for one warm CG+GAMG solve (f64 cycle);
  surface  the rest of the core surface on the card: each Vec method
           (arithmetic, reductions, values, sub-vectors, strides) on 128^3
           (2,097,152-entry) vectors against numpy float64 on the host
           (elementwise to 1e-15 relative, reductions to 1e-12), max/min
           with the first index on ties, equal exact, setRandom in float64
           and float32 equal to the JAX package's draw (its SHA-256);
           multAdd on the assembled 128^3 operator; the jacobi variants'
           diagonals against numpy on its host CSR; CG with pbjacobi (bs 1:
           CG+Jacobi's 184 iterations and history to 1e-6; bs 2 and 4:
           converged, relres <= 1e-8), with a shell PC doing Jacobi (184,
           the same history) and matSolve on three columns (each equal to
           its own solve); log.event(sync=) on a CUDA tensor around a 10 ms
           spin, which must last the spin;
  maij_kaij  MatMAIJ.create(A, 3) and MatKAIJ on that assembled matrix:
           mult (M1) and multTranspose (M1 on A's explicit transpose)
           against their plain versions (1e-12), CG with -pc_type none to
           rtol 1e-8 on the three-component b of maij_rhs (6,291,456
           unknowns); one Radau IIA 3-stage stage system I (x) I_3 + A (x)
           (0.01 A_RadauIIA) by GMRES(30), b = 1; each against `python
           mat7_contract.py 128 maij|kaij` (MAT7_CONTRACT: its, reason,
           history to 1e-6, true residual) with exact launches, warm and
           profiled; then M1 on its chunk-edge cases (m1_edge_cases, k =
           1, 2, 3, 4, 5, 8, 9 and 16, f64 and f32, vals and col also one
           element past a 16-byte edge, X one and in f32 two) and on the 128^3 CSR at k = 3 (f64,
           f32), 1, 2, 4 and 8 (f64), 1 and 8 (f32) and on the explicit
           transpose, against its plain version (1e-12 / 1e-5, equal bits
           on a rerun), timed beside its bound, the plain version,
           torch.sparse_csr_tensor @ X, k launches of S2 and the earlier
           warp-per-row design (earlier_kernels/) in turns (earlier, S2,
           new, new, S2, earlier);
  mat_shell_dense  CG+Jacobi at 128^3 on the stencil Mat, on a
           Mat.createShell over its mult and diagonal, and on
           Mat.createStencil with box27's 27 coefficient planes (aij_dnd,
           V1's window kernel), each 184 its with exact launches and a
           history equal to the stencil Mat's to 1e-12, warm and (the last
           two) profiled; KSP.matSolve with CG + GAMG's structured head (f64
           cycle) on a MatDense of four columns (matsolve_rhs), which
           returns a MatDense whose columns equal ksp.solve of each column
           (1e-12) and `python mat7_contract.py 128 matsolve` (column 0
           10 its), launches exact;
  gamg_grid  CG + GAMG with the structured head on bench.py's solve:
           build_dnd((128,)*3, "box") + as_mat, rtol 1e-8, max_it 60, every
           GAMG option at its default, in the f32 cycle (-pc_mg_dtype single,
           bench's configuration) and the f64 cycle, every launch count set to
           0 just before init and read just after the solve; asserts the
           reference's 10 iterations, CONVERGED_RTOL, relres <= 1e-8, its
           history (GAMG_GRID_HIST, 1e-6; f32 1e-4), rows and A and P kinds
           per level, each Chebyshev bound (1e-8; f32 1e-4), a true residual
           no worse than 10x the reference's, and the launches of
           grid_launches_needed (set-up probes and Lanczos included);
           reports the set-up seconds by part (head, tail download,
           aggregation tail), the warm solve and its ratio to CG+Jacobi's,
           and that every V1 level took the window kernel; holds V1's window
           kernel (the 64^3, 32^3 and 16^3 levels, 27 planes, and 65^3),
           V1's generic kernel (offsets reversed; a radius-2 star), Q1P
           (128^3 <- 64^3, 129^3 <- 65^3, 64^3 <- 32^3) and Q1R (128^3 ->
           64^3, 129^3 -> 65^3, 64^3 -> 32^3) against their plain versions
           (f64 1e-13, f32 1e-6; V1, Q1P and Q1R bit for bit), each timed
           beside its plain version and, at the odd size, F.interpolate or
           F.conv3d; V1's window, Q1P and Q1R also beside their earlier
           designs (V1's generic kernel; earlier_kernels/, built by its own
           nvcc in phase build) in turns, earlier, new, new, earlier; Q1R's
           plan (its 16-byte variant) on every Q1 level of the path; and
           the card's probed 32^3 planes against the host Galerkin product
           of the port's SpGEMM (1e-12);
  gamg_grid_profile  the profile phase for one warm solve of each cycle,
           with Q1R's and Q1P's µs per launch on each Q1 level;
  gmres_ilu  BASELINE config 2 through the user's entry points: init with
           -ksp_rtol 1e-8 -ksp_max_it 400, the atmosmodd-class stencil7 on
           22 x 239 x 239 (1,256,662 rows, 8,661,360 entries) as a MatAIJ
           from COO triplets, KSP and PC types left to their defaults,
           b = A cos(0.01 i), x0 = 0, every launch count set to 0 just
           before init and read just after the solve; asserts the default
           types (gmres, ilu with 0 levels), the reference's 11 iterations,
           CONVERGED_RTOL, its history (GMRES_HIST, 1e-6), a true residual
           and max |x - cos(0.01 i)| no worse than 10x the reference's, and
           exact launches (K1 1, K8 2, K3 its, T1 2 (its + 1), S2 its, no
           other kernel); times warm solves (best of 3); holds T1 against
           its plain version bit for bit on both sweeps of the path's ILU(0)
           factors (f64 and f32 vectors; each must take the cluster
           variant) and on small odd shapes (the four sweeps of an ILU(1)
           plan, a float32 factor, a one-level diagonal wider than a
           cluster, which must take the grid variant), each timed beside
           its plain version and, on the path's sweeps,
           torch.triangular_solve on the sweep's triangle as a sparse CSR
           (cuSPARSE); on the path's sweeps also the grid variant and the
           earlier grid-barrier design (earlier_kernels/, built in phase
           build), each bit for bit and timed in turns (earlier, grid,
           new, new, grid, earlier), the same sweeps with every entry
           removed (the barrier and the row loads alone) in turns, and the
           cluster's shape (16 or 11 blocks; 2 blocks or 1 on the ILU(1)
           sweep); each row names its variant, cluster, blocks, threads,
           rows per thread, registers and blocks per SM; then the same operator at
           6 x 60 x 60 with -pc_bjacobi_blocks 4, -ksp_type bcgs, -pc_type
           sor, -ksp_type preonly -pc_type lu and -ksp_pc_side right, each
           against its contract (GMRES_SMALL);
  gmres_ilu_profile  the profile phase for one warm solve of config 2, with
           T1's µs per launch and per level (T1 24 launches and nothing
           else of the port's kernels);
  ex56     PETSc's ex56 (3-D Q1 elasticity, block size 3, six rigid-body
           modes) through the port's entry points (the steps of
           petsc_tpu_torch/examples/ex56.py): ne 64 at the defaults (CG +
           GAMG, rtol 1e-4, unpreconditioned norm; 823,875 rows, 64,701,513
           entries), assembled from 3 x 3 element blocks, from_scipy,
           setBlockSize(3) (kind aij_bsr, no CSR left on the card),
           MatNullSpace.createRigidBody, every launch count set to 0 just
           before the set-up and read just after the solve; asserts the
           contract of `python ex56_contract.py 64 defaults` (EX56_CONTRACT:
           its, reason, history to 1e-6, rows and aggregates per level, the
           level-0 aggregates' hash, a true residual no worse than 10x) and
           exact launches (ex56_launches_needed: B1 for level 0's products
           and CG's); the seconds of assembly, from_scipy, setBlockSize, the
           set-up by event and the first solve; the warm solve (best of 3)
           and one profiled warm solve; B1 against its plain version on that
           operator in f64 and f32 (equal bits), timed beside its bound, the
           plain version, the earlier per-output design (earlier_kernels/,
           built in phase build) in turns, earlier, new, new, earlier, S2 and
           torch.sparse_csr_tensor @ x (the library call) on the same
           operator as CSR and cuSPARSE's BSR product, and on random BSRs of
           bs 2, 3, 5 and 6 over 30,000 block rows with a row of 500 blocks
           and an empty row (equal bits); then the knob set of
           PETSc's ex56 test (HEM, strength index 1,2, the aggregate-block
           smoother on A1, Chebyshev(1, 1), CG+Jacobi on the coarsest level)
           at ne 11 (10 its), ne 11 with the transposed modes of ex56.c (15)
           and ne 24 (13), each against its contract with its launches (A1,
           C1's z modes and B1 exact), ne 24 timed and profiled; A1 against
           its plain version (f64 1e-12, f32 1e-5) on every level's tables
           of ne 24's solve and on the tables of ne 64's operator over the
           defaults' level-0 aggregates, ne 24's level 0 and ne 64 timed
           beside the bound, the plain version, the earlier 16-row design
           (earlier_kernels/) in turns and torch.bmm on the reference's
           padded table; C1's z modes against their plain
           version at ne 24's level-0 length, timed beside their bound;
  sbaij    ex56 ne 64's assembled CSR as MatSBAIJ.from_scipy (the upper
           triangle on the host; bs-1 CSR on the card until setBlockSize(3)):
           the expanded CSR equal to the upper triangle's nonzeros mirrored
           (within 1e-15 of the assembled one), then CG + GAMG at the defaults against
           phase ex56's contract and history, exact launches, warm and
           profiled;
  ex45     PETSc's ex45 (the 3-D Laplacian on a DMDA) through the steps of
           petsc_tpu_torch/examples/ex45.py at -da_grid_x|y|z 129
           (2,146,689 rows), CG to rtol 1e-8, under -pc_type mg (PCMG
           from the DM: 7 levels, each rediscretized by compute_operators,
           aij_dnd on V1, Q1P/Q1R) and -pc_type gamg (the structured head
           on the DM's grid, then the host tail), every launch count set to
           0 just before init and read just after the first solve; asserts
           the contract of `python ex45_contract.py 129 mg|gamg`
           (EX45_CONTRACT: its, reason, history to 1e-6, rows, operator and
           transfer kinds per level, nnz, a true residual no worse than
           10x) and exact launches (ex45_launches_needed); the host
           seconds by event (compute_operators on each level, PCSetUp),
           the warm solve (best of 3) and one profiled warm solve; the host
           seconds of node_coords and interior_mask at 129^3; V1 on the
           level-0 operator against its plain version (equal bits), timed
           beside its bound; the dof-3 form at 65^3 (823,875 rows, aij_bsr
           on B1, PCMG from the DM with Galerkin coarse levels, against
           `python ex45_contract.py 65 dof3`, exact launches, warm solve);
           Q1P and Q1R at dof 2 (1025^2) and dof 3 (65^3), f64 and f32,
           against their plain versions (1e-12, 1e-5), timed beside the
           plain version, the bound and F.interpolate / a depthwise
           F.conv; ex2 (-ksp_monitor) and ex1 (-ksp_view) on the card, their
           text held to the same runs under init(device="cpu");
  krylov   the Krylov types of item 8 (KRYLOV_CASES), each case's first
           solve held to `python krylov_contract.py` (tests/data/
           krylov_contract.json: its, reason, history to 1e-6, pipecg's
           plus 1e-11 of the initial norm; the mixed case's first
           refinement pass to the reference's its, each later one within
           one, its outer norms after the first within 10x; a true
           residual no worse than 10x) with every launch count set to 0 just before
           and exact launches after (krylov_launches_needed): config 2
           (1,256,662 rows) assembled from COO with ILU(0) and
           -pc_factor_transpose_solve, one PC set-up shared by cgs, tfqmr,
           bcgsl, ibcgs, idr, lgmres, dgmres (restart 4), gcr, tcqmr,
           qmrcgs and bicg (T1 on the transpose tables); the same operator
           on its grid (aij_dnd: V1, and V1T for A^T) with bicg + jacobi,
           cgls and lsqr; -ksp_mixed_precision (f64 refinement around
           GMRES(30) + ILU(0) in f32); the 128^3 box27 stencil (S1) with
           jacobi for cr, fcg, pipecg, symmlq and stcg (setRadius); each
           case's warm solve (best of 3) and one profiled solve (busy ms,
           share); V1T against its plain version (equal bits) and timed
           beside it, its bound and V1;
  pc       the PC types of item 8 (PC_CASES) through the user's entry
           points, each case's first solve held to `python pc_contract.py`
           (tests/data/pc_contract.json) with exact launches
           (pc_launches_needed), its warm solve (best of 3) and one
           profiled solve; then X1 (add on the ex59-class MatIS, set on
           config 2's ASM, signed on fetidp's B, and NN's W r as long
           runs), D1 (the MatIS's Ab, BDDC's K_qq^-1 through its output
           map with accumulate, Phi, Phi^T) and N1 on the path's tables,
           each against its plain version (X1 and N1 bit for bit) and
           timed in turns with its earlier design (earlier_kernels/),
           beside its bound, plain version, library call and K1's launch
           probe in the same phase;
  nonlinear  SNES, TS and Tao (item 10) through the user's entry points
           (NONLINEAR_CASES): PETSc's ex5 (Newton LS, the COO Jacobian into
           the DMDA's aij_dnd matrix, CG + GAMG's structured head) at 257^2
           and 1025^2, ex19 (JFNK with the FD-colouring pmat, GMRES(30) +
           ILU(0)) at -da_refine 3 and 6, Crank-Nicolson heat steps with the
           device-loop JFNK at 129^2 and 1025^2, an rk 3bs adjoint at
           257^2, Tao lmvm and nls on the chained Rosenbrock at n = 2^20;
           each case's first run held to `python snes_contract.py`
           (tests/data/snes_contract.json: its, reason, histories to 1e-6
           relative, entries below 1e-6 of the first to 1e-12 of the first;
           vectors' norm and 16 samples to 1e-10) and to SNES_TS_r05.json
           (ex5 257^2's history, the 129^2 CN step's t_end and error), its
           launches exact (nonlinear_launches_needed), its host set-up split
           (Jacobian assembly with each setPreallocationCOO and
           setValuesCOO, PCSetUp, colouring), its warm run (best of 2; one
           where a run takes over 5 s) and one profiled run (the card's
           activity alone: busy ms, share);
  plex     DMPlex, PetscFE/DS and FV on Plex (item 11, first half) through
           the user's entry points (PLEX_CASES): PETSc's SNES ex12 (P2,
           petsc_tpu_torch/examples/ex12.py) at 256^2 faces (263,169 dofs,
           GMRES + GAMG) and 64^2 (PETSc's defaults), CG + PCMG from a
           createBoxMesh((64, 64)) refined 4 times (1,050,625 rows, 5
           levels), second-order FVPlex advection (upwind, Barth-Jespersen,
           SSP-RK2) on 724^2 x 2 triangles; each case's first run held to
           `python plex_contract.py` (tests/data/plex_contract.json: its,
           reasons and inner its equal, histories to 1e-6 relative, ex12's
           u, nodal error and the MG solution to 1e-8, FV's u to 1e-10 of
           max|u|), its launches exact (plex_launches_needed), its host
           seconds by part (mesh, refine, dof layout, face geometry,
           residual, Jacobian, COO, PC set-up), its warm run (best of 2; one
           where a run takes over 5 s) and one profiled run; then X1's add
           (the DS residual), signed (the FV fluxes) and min (the limiter)
           modes on those tables, each against its plain version bit for
           bit and timed;
  dm_more  the rest of DM and item 13 through the user's entry points
           (DM_MORE_CASES): examples/stokes_stag.py's MAC Stokes on a DMStag
           (FGMRES + fieldsplit Schur full/selfp, ILU(0) and Jacobi blocks)
           at n = 64 and 512 (787,456 unknowns), its CSR's hash the
           reference's; DMSwarm on a 1025^2 DMDA (ppcell 4) and a 129^3 one
           (ppcell 2), 16,777,216 particles each, permuted, depositSum,
           projectFields, interpolateToParticles (W1, W2) and migrate;
           DMNetwork on the 512 x 512 grid graph (createMatrix's pattern,
           the KCL Laplacian from incidence(), CG + GAMG); the LETKF
           (16,384 points, 32 members, 2,048 observations, Gaspari-Cohn);
           PetscRegressor OLS (thin SVD), ridge and lasso on a 131,072 x 64
           design; PF "x*x + 1" and Random.getValues on 2^24 entries; config
           2's matrix in PETSc binary and ex45's 129^3 right-hand side as
           .vti from card tensors; each case's first run held to `python
           dm_contract.py` (tests/data/dm_contract.json: its, reasons,
           histories to 1e-6 or twice the reference's own spread, vectors'
           norms and samples, equal hashes and files) with exact launches
           (dm_more_launches_needed), its host seconds, warm run and one
           profiled run; then W1 and W2 on the swarms' shapes, each equal
           in bits to its plain version (W1's run on the host's CPU, f64
           and f32, given the cell order, bare and with every tile dense)
           and timed: W1 with its order given in turns with the
           earlier atomic design, cell_order alone, the bare call,
           index_add_, the plain version and the bound with its bytes, on
           the uniform swarms and on a Gaussian cluster of as many
           particles; W2 beside its earlier launch shapes, the shapes
           without the division (timing only) and grid_sample; HDF5 is
           left out (no h5py on the card's machine);
  bench_gpu  python bench_gpu.py in a process of its own (the kernels built
           above reused): its JSON line, and its contract, BENCH_r05.json's
           solve (10 iterations, relres <= 1e-8, jacobi_its 184), the small-n
           check passed, every quality "measured", pct_stencil_roofline <= 100;
  dist     distribution over ranks: 4 spawned gloo ranks (one process each,
           sharing the card; a file store, a 300 s group timeout) run
           DIST_CASES (the main path sharded, dnd_mpi with the sharded head,
           at 128^3 in f64 and f32 cycles; CG+Jacobi on the 128^3 box27 as
           mpiaij; distributed aggregation GAMG and bjacobi at 64^3;
           fieldsplit-Schur at 16^3), each rank holding its its, reason,
           history (1e-6; f32 1e-4), levels and true relres (<= 10x) to
           tests/data/dist_contract.json and its launches exactly to
           dist_launches_needed, with warm ms, busy share, bytes an
           iteration, host seconds and the slab copy's time; which gloo
           collectives take CUDA tensors; then a one-rank NCCL group runs
           the collectives on CUDA tensors and checks them; the parent
           joins every rank and fails on any exit code but 0.
Then the kernel table as one JSON line (K2's, K4's and S1's rows also name
their design, launch shape and share of the bound, S1's with its cp.async
path, star and f32 times beside; V1's, Q1P's and Q1R's are the f32 cycle's,
each with earlier_ms, the earlier design's time in the same turns, Q1R's
and Q1P's with their µs per launch on each level of both cycles; T1's is
config 2's forward sweep in f64, with its variant, the grid variant's and
the earlier design's times from the same turns, the entries-removed sweeps
and the other sweeps beside it; B1's is ex56 ne 64's operator in f64, A1's
ex56 ne 24's level-0 tables in f64, C1z's (C1's z modes, counted apart)
the step_z mode in f64 at that level's length; M1's the MAIJ product
(k = 3, f64) on the 128^3 CSR, with S2 per column and the earlier design
in the same turns; V1T's config 2's grid transpose in f64;
Q1P's and Q1R's rows
carry their dof rows and ex45's µs per level, V1's its time on ex45's
level 0;
every row of the path's kernels its µs per launch inside each solve, and
every row its launches in each phase of bench_gpu.py), the nvidia-smi
line, and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero. With
no CUDA device, or without the package beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# HBM3 bandwidth, and dense non-tensor-core rates for each type
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
TOL = {"float64": 1e-12, "float32": 1e-5}
N_MAIN = 128
ITS_MAIN = 184                  # CG+Jacobi at 128^3 (BENCH_r05.json jacobi_its)
NNZ_MAIN = 55_742_968           # box27 at 128^3
REPS = 20
SLEEP_CYCLES = 200_000          # about 0.1 ms of the card's clock, before each timed launch
WARMUP_SPINS = 20               # spin kernels on each side of a profiled solve (profile_solve)
SPIN_CYCLES = 2_000_000         # about 1 ms of the card's clock each
_SPINS = [WARMUP_SPINS]         # leading spins of the next profile (profile_solve)
PROBE_SHUFFLE = (1_048_576, 4096, 128)   # C, B, W of pallas_shuffle_probe.py probe_s1/s2/s3
PROBE_GATHER = (524_288, 4_194_304)      # n, m of pallas_gather_probe.py probe_g1
# the designs of K2 and K4 (triad.cu, dot2.cu; the measurements behind them are in PERF.md)
DESIGN = {"triad": "registers: one tile of 16-byte packs per block, one pack of b and of c "
                   "per thread, as many blocks as tiles",
          "dot2": "registers: one wave, rounds of 8 packs of x and of y per thread "
                  "interleaved across the grid, one launch (last-block sum)",
          "const_stencil": "2.5-D march: 8 x 32 (i1 x i2) tiles walking 16-plane chunks of i0, "
                           "planes through a 2-slot TMA ring (cp.async where TMA cannot take "
                           "the shape), i0 and i1 sums in registers, the i2 sum from a shared "
                           "plane"}
# kernel -> the part of its device function's name that the profiler shows
IN_SOLVE = {"triad": ("triad_kernel",), "axpy_normsq": ("axpy_normsq_kernel",),
            "dot2": ("dot2_kernel",), "sum_partials": ("sum_partials",),
            "const_stencil": ("const_stencil_kernel",), "csr_spmv": ("csr_spmv_kernel",),
            "cheby_update": ("cheby_update_kernel",),
            "cheby_update_z": ("cheby_update_z_kernel",),
            "bsr_spmv": ("bsr_chunk_kernel",), "agg_block_apply": ("agg_block_kernel",),
            "agg_block_cheby": ("agg_block_cheby_kernel",),
            "dnd_stencil": ("dnd_stencil_kernel", "dnd_window_kernel"),
            "q1_prolong": ("q1_prolong_kernel",), "q1_restrict": ("q1_restrict_kernel",),
            "trisolve": ("trisolve_kernel",), "csr_spmm": ("csr_spmm_kernel",),
            "dst_scatter": ("dst_scatter_kernel",),
            "subdomain_apply": ("subdomain_rows_kernel", "subdomain_narrow_kernel",
                                "subdomain_narrow_t_kernel", "subdomain_t_kernel"),
            "neumann_step": ("neumann_step_kernel",),
            # the Krylov basis products of GMRES (torch.mv: cuBLAS gemv)
            "gemv": ("gemv",),
            # torch.linalg.lu_solve: the library's row swaps and triangular solves
            "lu_solve": ("getrs", "trsm", "trsv", "laswp")}
# CG+PCMG on the assembled 128^3 box27 (b = 1, x0 = 0, rtol 1e-8) with the Q1
# Galerkin hierarchy 128 -> 64 -> 32 -> 16 -> 8, Chebyshev(2, 2) with Jacobi
# inside, bounds from the host Arnoldi through the (0, 0.1, 0, 1.1) transform,
# a V-cycle and a dense LU on 8^3: the JAX package's own run of this solve on
# the CPU (JAX 0.9.0, x64, at be556ca; PERF.md section 4, "The PCMG contract").
MG_GRIDS = (128, 64, 32, 16, 8)
MG_ITS = 10                      # both cycles, CONVERGED_RTOL
MG_NNZ = (55_742_968, 6_859_000, 830_584, 97_336, 10_648)   # each Galerkin level
MG_HIST = {                      # the reference's preconditioned residual norms
    "f64": (49563.67337386738, 8091.288403778846, 1185.7204581220567, 113.27539284216874,
            22.048883470060787, 2.9462065578028818, 0.2894169886473891, 0.05336026415492263,
            0.009852026720010149, 0.0011099129385644395, 0.0001997042114828755),
    "f32": (49563.65828194131, 8091.287531569806, 1185.720338353673, 113.27537008291125,
            22.0488852102289, 2.946204261252398, 0.28941681374387046, 0.053360198174700356,
            0.009852002533776938, 0.0011099121622906909, 0.00019970642467384434)}
MG_HIST_TOL = {"f64": 1e-6, "f32": 1e-4}
MG_TRUE_RELRES = {"f64": 3.6660472412399075e-07, "f32": 3.666041979185221e-07}
# CG+GAMG on the assembled 128^3 box27 (b = 1, x0 = 0, rtol 1e-8, no grid declared,
# every GAMG option at its default: MIS-2 with the square fix on level 0 and MIS
# above, threshold -1, one prolongator smoothing, coarse limit 50, Chebyshev(2, 2)
# with Jacobi inside, a V-cycle, a dense LU on the coarsest level): the JAX
# package's own run on the CPU (gamg_contract.py, JAX 0.9.0, x64, at 1ca26ec;
# PERF.md section 4, "The GAMG contract").
GAMG_ITS = 9                     # both cycles, CONVERGED_RTOL
GAMG_ROWS = (2097152, 44998, 2942, 98, 6)
GAMG_NNZ = (55742968, 1927758, 354992, 6876, 36)
GAMG_P_NNZ = (8667065, 406117, 28872, 384)
GAMG_AGGS = (44998, 2942, 98, 6)
GAMG_AGG0_SHA256 = "06986038dd541b5202b4aacd9d8925a9d0f0d3d53dde52a1cc23892548992d99"
GAMG_EMAX = (1.4899285139417946, 1.3888911577172938, 2.027590335996151, 1.5482701293031504)
GAMG_HIST = {                    # the reference's preconditioned residual norms
    "f64": (43727.41174942675, 2386.273450291819, 188.65595734573688, 32.55989453209206,
            3.2011965544537127, 0.2665557978119956, 0.03417290666352907, 0.005351413735419906,
            0.0007329287945115259, 9.111378592584698e-05),
    "f32": (43727.38821592011, 2386.2726283549273, 188.65609423496133, 32.55989934120367,
            3.201196543114481, 0.26655607419116567, 0.03417296410690065, 0.005351416084630673,
            0.0007329280867813135, 9.111379572104851e-05)}
GAMG_TRUE_RELRES = {"f64": 1.5840455245758786e-07, "f32": 1.5840445034639022e-07}
# CG+GAMG with the structured head on the 128^3 box27 stencil operator of
# bench.py's solve (build_dnd + as_mat, b = 1, x0 = 0, rtol 1e-8, max_it 60,
# every GAMG option at its default: Q1 levels probed on the device down to the
# structured limit of 3000 rows, then smoothed aggregation on the 8^3 tail,
# Chebyshev(2, 2) with Jacobi, a V-cycle, a dense LU on the coarsest level):
# the JAX package's own run on the CPU (gamg_contract.py 128 f64|f32 grid,
# JAX 0.9.0, x64; PERF.md section 4, "The GAMG grid contract"). The f32 cycle
# probes and stores its head in float32, so its numbers are its own.
GAMG_GRID_ITS = 10                # both cycles, CONVERGED_RTOL
GAMG_GRID_ROWS = (2097152, 262144, 32768, 4096, 512, 56, 5)
GAMG_GRID_A_KINDS = ("aij_dnd",) * 5 + ("aij_csr",) * 2
GAMG_GRID_P_KINDS = ("interp_q1",) * 4 + ("aij_csr",) * 2
GAMG_GRID_EMAX = {
    "f64": (1.4899191587925669, 1.6058632483760877, 1.787887093598119, 2.029256163213922,
            2.1354329933134957, 2.722619484868784),
    "f32": (1.4902479887008668, 1.6071424484252932, 1.7866171002388003, 2.0063850522041324,
            2.1354329941905665, 2.7226194869089815)}
GAMG_GRID_EMAX_TOL = {"f64": 1e-8, "f32": 1e-4}
GAMG_GRID_HIST = {              # the reference's preconditioned residual norms
    "f64": (46860.812329914144, 7488.182148857781, 1096.8634550591057, 111.47676981915953,
            22.57428172919544, 3.359027910593749, 0.31652433151342046, 0.05881924956690744,
            0.010350121999600875, 0.0011633350764347042, 0.00020551337644568885),
    "f32": (46908.5729228788, 7467.259498456695, 1099.135207888274, 111.13731263787366,
            22.514524331164907, 3.3361238063020826, 0.31329839407697424, 0.05801988656332334,
            0.010227804382415587, 0.001152828673593543, 0.0002051037246532732)}
GAMG_GRID_TRUE_RELRES = {"f64": 3.4892518396667014e-07, "f32": 3.464988762724443e-07}
# BASELINE config 2, PETSc's default solver on an assembled MatAIJ: the
# atmosmodd-class 7-point stencil (examples/bench_spmv.py stencil7, jittered,
# not symmetric) on 22 x 239 x 239 from COO triplets, KSP and PC types left
# to their defaults (GMRES(30) with CGS refine_never, ILU(0) in natural
# order), rtol 1e-8, max_it 400, b = A cos(0.01 i), x0 = 0: the JAX
# package's own run on the CPU (gmres_contract.py 22 239 239, JAX 0.9.0,
# x64; PERF.md section 4, "The GMRES contract").
CONFIG2 = (22, 239, 239)
CONFIG2_ROWS = 1_256_662
CONFIG2_NNZ = 8_661_360
GMRES_ITS = 11
GMRES_HIST = (848.0979975918227, 7.895284832119265, 1.032136412182085, 0.19610295037731704,
              0.04244423997918057, 0.009689307039903056, 0.002279009915680267,
              0.0005746977217869913, 0.00015849109405091514, 4.589452877442304e-05,
              1.3394245821427273e-05, 3.880759703750617e-06)
GMRES_TRUE_RELRES = 3.0519833226491575e-09
GMRES_MAX_ERR = 8.67512024438355e-08     # max |x - cos(0.01 i)|
GMRES_HIST_TOL = 1e-6
# the same operator at 6 x 60 x 60 with other solvers (gmres_contract.py 6 60 60
# OPTIONS): name -> (options, its, reason, history, true relres, max error)
CONFIG2_SMALL = (6, 60, 60)
GMRES_SMALL = {
    "bjacobi4": (("-pc_type", "bjacobi", "-pc_bjacobi_blocks", "4"), 17, "CONVERGED_RTOL",
                 (106.28751718759791, 17.68367320622351, 4.535544685743181, 1.5637286597504076,
                  0.5612216228078427, 0.2026781973644178, 0.04052294686542281, 0.018565925872627,
                  0.0057226491482961625, 0.002338008668111242, 0.0009395712180719411,
                  0.0003896458391197079, 0.00013500056666024287, 4.99325074361969e-05,
                  1.7711859385281396e-05, 7.667037465797015e-06, 3.16200117563434e-06,
                  1.015626605810705e-06),
                 1.1486029919336165e-08, 5.8683511827695156e-08),
    "bcgs": (("-ksp_type", "bcgs"), 6, "CONVERGED_RTOL",
             (101.574250137108, 0.8828324304508245, 0.04137988973394392, 0.0018343039156026144,
              0.00010057554949629235, 1.1617530038744956e-05, 7.689977775857862e-07),
             8.258622559317764e-09, 4.014013160746899e-08),
    "sor": (("-pc_type", "sor"), 12, "CONVERGED_RTOL",
            (89.46218811089308, 6.07713846256955, 0.857057006866332, 0.2445173008710027,
             0.032410322281995176, 0.007182738127461455, 0.0015823115226403523,
             0.00044631966188986305, 0.00011162961388410586, 3.0194427537967532e-05,
             6.949932811603596e-06, 1.9410068378901434e-06, 4.726394423331406e-07),
            5.047882158922971e-09, 3.6352386212357146e-08),
    "preonly_lu": (("-ksp_type", "preonly", "-pc_type", "lu"), 1, "CONVERGED_ITS", (),
                   4.0553531756387297e-16, 1.1102230246251565e-15),
    "pc_side_right": (("-ksp_pc_side", "right"), 11, "CONVERGED_RTOL",
                      (344.9499283438119, 18.276735833538382, 2.0495469087899503,
                       0.45717716348952614, 0.06963892360757604, 0.011821791758976836,
                       0.002189962069385343, 0.0004954246590874884, 0.00010629554528836887,
                       2.5940451926819723e-05, 5.4116419948930926e-06, 1.2920464797450229e-06),
                      3.745605877367126e-09, 3.9532141560272294e-08),
}
# Phase krylov: the Krylov types beyond the main path's, each held to the
# reference's run of the same case (krylov_contract.py, the JAX package on
# the CPU in f64). Config 2's operator (CONFIG2, b = A cos(0.01 i), x0 = 0,
# rtol 1e-8, max_it 400) assembled (ILU(0) with -pc_factor_transpose_solve:
# one PC set-up serves every type, the transpose sweeps are bicg's and
# ibcgs's Bᵀ), on its grid (setStencilGrid: V1 and V1ᵀ) and under
# -ksp_mixed_precision (IR around GMRES(30) + ILU(0)); the main path's 128³
# box27 stencil operator (S1, b = 1, rtol 1e-8, max_it 3000) with jacobi.
KRYLOV_CSR_TYPES = ("cgs", "tfqmr", "bcgsl", "ibcgs", "idr", "lgmres", "dgmres", "gcr",
                    "tcqmr", "qmrcgs", "bicg")
KRYLOV_CSR_ARGS = ("-ksp_rtol", "1e-8", "-ksp_max_it", "400", "-pc_factor_transpose_solve")
# dgmres restarts every 4 steps, so that its deflation runs and its history
# (one entry per cycle) stays above the rounding level; a 30-step cycle
# ends at a norm of 2.6e-12 that no two summation orders share
KRYLOV_CSR_EXTRA = {"dgmres": ("-ksp_gmres_restart", "4")}
KRYLOV_GRID_PCS = {"bicg": "jacobi", "cgls": "none", "lsqr": "none"}
KRYLOV_MIXED_ARGS = ("-ksp_rtol", "1e-8", "-ksp_max_it", "400", "-ksp_mixed_precision")
KRYLOV_BOX_ARGS = ("-pc_type", "jacobi", "-ksp_rtol", "1e-8")
# type -> max_it: fcg takes PETSc's default, 10000, since the reference's
# fcg loop tests ||r|| (not its) against max_it (impls_more.py:486) and at
# 3000 stops after one step, where ||r|| passes 3000 (ROADMAP section 3)
KRYLOV_BOX_MAX_IT = {"cr": 3000, "fcg": 10000, "pipecg": 3000, "symmlq": 3000, "stcg": 3000}
KRYLOV_STCG_RADIUS = 3e5        # stcg's trust region (setRadius)
KRYLOV_BOX_N = 128
# the histories: 1e-6 relative to each entry; pipecg also 1e-11 of the
# initial norm (the rounding-level rule of tests/test_torch_gmres.py): its
# recursive residual on the 128^3 box27 ends 1.5e-8 below its start, where
# the port on the CPU differs from the reference by 8.5e-6 of the entry,
# 1.3e-13 of the initial norm
KRYLOV_HIST_TOL = 1e-6
KRYLOV_HIST_ATOL = {"box_pipecg": 1e-11}
# the mixed case: its initial norm to KRYLOV_HIST_TOL; each later entry, a
# true residual norm after an f32 inner solve, within this factor of the
# reference's, as the true relres is (the f32 solve's rounding sets it:
# `python krylov_contract.py 22 239 239 passes`)
KRYLOV_IR_FACTOR = 10.0
# PETSc's ex56 (3-D Q1 elasticity, bs 3, six rigid-body modes) through the
# port's example program (petsc_tpu_torch/examples/ex56.py); the contracts come from
# `python ex56_contract.py NE defaults|knobs|transposed` (the JAX package on
# the CPU, the modes in createRigidBody's order)
EX56_DEFAULTS = ["-ksp_type", "cg", "-pc_type", "gamg"]
EX56_KNOBS = [                   # tests/test_parity_gamg.py EX56_REF_ARGS without -ne
    "-alpha", "1e-3", "-ksp_type", "cg", "-pc_type", "gamg",
    "-pc_gamg_agg_nsmooths", "1", "-mg_levels_ksp_max_it", "1",
    "-mg_levels_ksp_type", "chebyshev", "-mg_levels_ksp_chebyshev_esteig", "0,0.2,0,1.05",
    "-pc_gamg_asm_use_agg", "-mg_levels_sub_pc_type", "lu", "-mg_levels_pc_asm_overlap", "0",
    "-pc_gamg_mat_coarsen_type", "hem", "-pc_gamg_mat_coarsen_max_it", "5",
    "-ksp_rtol", "1e-4", "-pc_gamg_threshold", ".001",
    "-pc_gamg_mat_coarsen_strength_index", "1,2",
    "-mg_coarse_pc_type", "jacobi", "-mg_coarse_ksp_type", "cg",
]

EX56_CONTRACT = {                # (ne, mode): its, history, rows per level, true relres, level-0 aggregate hash
    (64, 'defaults'): {
        "its": 17, "rows": (823875, 35934, 2496, 102, 6), "nnz": 64701513,
        "aggregates": (5989, 416, 17, 1),
        "true_relres": 7.090744541778965e-05,
        "agg0_sha256": "a253bda1682b5c15d38204d8581ec6f27d05f7b5c2992bdbb7d0336343e2d1f4",
        "history": (2.2055607851170898, 36.39986695643594, 18.458182066501582,
                    9.092853976681585, 5.1094216576697535, 2.0717537453591066,
                    0.98971278986756, 0.468043976025925, 0.22369644621316187,
                    0.09840410416633662, 0.03922113495939393, 0.017380507332418485,
                    0.007362956908980622, 0.003206017562234951, 0.0015611625301389378,
                    0.0007495055029193579, 0.0003673752327298481, 0.00015639068098924545),
    },
    (11, 'knobs'): {
        "its": 10, "rows": (5184, 330, 18), "nnz": 353736,
        "aggregates": (55, 3),
        "true_relres": 3.064775794663372e-05,
        "agg0_sha256": "5258518809e8ffd17a4bfd2e8467b53db8c6ea3e06430f158d8aa7bd16a19394",
        "history": (4.969822187252951, 15.465610750138877, 5.388114730111979,
                    1.661168963886931, 0.42682189288050026, 0.09304276224749512,
                    0.025781367779802798, 0.007075418438898656, 0.002104150783103763,
                    0.0005731728594559511, 0.00015231390742273456),
    },
    (11, 'transposed'): {
        "its": 15, "rows": (5184, 330, 18), "nnz": 353736,
        "aggregates": (55, 3),
        "true_relres": 5.121387908550248e-05,
        "agg0_sha256": "5258518809e8ffd17a4bfd2e8467b53db8c6ea3e06430f158d8aa7bd16a19394",
        "history": (4.969822187252951, 14.193105119238295, 9.216171938038473,
                    8.48346147862028, 4.880364376040141, 1.717126053439158,
                    0.6109333778317753, 0.2304596911304935, 0.08335275207102104,
                    0.02841557349305028, 0.014535998966385636, 0.009960896059464222,
                    0.005523110723761733, 0.002736781447821494, 0.0008737647211438174,
                    0.0002545238725878251),
    },
    (24, 'knobs'): {
        "its": 13, "rows": (46875, 3078, 126, 12), "nnz": 3501153,
        "aggregates": (513, 21, 2),
        "true_relres": 3.9059616450788913e-05,
        "agg0_sha256": "b637ff390fd95305156b83c54bd48333bb93237e115517eadb355bf77af794e6",
        "history": (3.5191019329300275, 22.93589038941649, 9.647222900393079,
                    4.245925650558096, 1.5241152408262193, 0.5542604479608565,
                    0.20311392147916044, 0.0783410458382291, 0.026289036028680116,
                    0.009176103598895601, 0.003560813831643963, 0.0012781451411164862,
                    0.00042270072243798034, 0.00013745477175739417),
    },
}
EX56_HIST_TOL = 1e-6

# PETSc's ex45 (the 3-D Laplacian on a DMDA) through the port's example
# program (petsc_tpu_torch/examples/ex45.py): the contracts come from
# `python ex45_contract.py 129 mg|gamg` and `python ex45_contract.py 65 dof3`
# (the JAX package on the CPU, float64)
EX45_N = 129
EX45_DOF3_N = 65
EX45_ARGS = ["-ksp_type", "cg", "-ksp_rtol", "1e-8"]
EX45_HIST_TOL = 1e-6
EX45_CONTRACT = {
    "mg": {"its": 7, "true_relres": 1.2623704591419126e-06, "nnz": 14436987,
           "rows": (2146689, 274625, 35937, 4913, 729, 125, 27),
           "kinds": ("aij_dnd",) * 7, "p_kinds": ("interp_q1",) * 6,
           "history": (63.51895966494416, 0.48806616039006867, 0.05768344353789537,
                       0.011490918237553601, 0.0008185059891504089, 0.00010376808043257735,
                       3.770842050486401e-06, 5.951820962599711e-07)},
    "gamg": {"its": 6, "true_relres": 3.5649278346502423e-07, "nnz": 14436987,
             "rows": (2146689, 274625, 35937, 4913, 729, 75, 6),
             "kinds": ("aij_dnd",) * 5 + ("aij_csr",) * 2,
             "p_kinds": ("interp_q1",) * 4 + ("aij_csr",) * 2,
             "history": (64.35246620162307, 1.201080875409304, 0.01090981623807066,
                         0.0003120301684096455, 1.559251239539435e-05, 7.396055187513974e-07,
                         6.206446032413588e-08)},
    "dof3": {"its": 6, "true_relres": 2.090866364350586e-07, "nnz": 5324721,
             "rows": (823875, 107811, 14739, 2187, 375, 81, 24),
             "kinds": ("aij_bsr",) + ("aij_csr",) * 6, "p_kinds": ("interp_q1",) * 6,
             "history": (5689681.605855285, 20485.81404821816, 546.0693444084463,
                         34.85445477039291, 1.5872633912398102, 0.17898562113330754,
                         0.005464802542686356)},
}
EX56_RTOL = 1e-4

# Phase pc: the PC types of item 8 held to the reference's runs of the same
# cases (pc_contract.py, the JAX package on the CPU in f64). Each case: the
# operator group and the options. config2: BASELINE config 2 assembled from
# COO (b = A cos(0.01 i), max_it 400); config2_grid: the same on its grid
# (setStencilGrid, aij_dnd); box: the 128^3 box27 assembled as CSR (b = 1);
# ex56: PETSc's ex56 at ne 64 (BAIJ bs 3, CG in the unpreconditioned norm,
# max_it 200); matis: the ex59-class Q1 Poisson MatIS (PC_MATIS, b from
# PC_MATIS_SEED); matis_nn: the same at PC_MATIS_NN (8 x 8 subdomains of the
# same size: the reference's NN set-up, a pseudo-inverse per subdomain and
# one MatIS product per subdomain for its coarse matrix, takes too long at
# 16 x 16 on the contract machine).
PC_CASES = {
    "c2_asm": ("config2", ("-ksp_type", "gmres", "-pc_type", "asm")),
    "c2_asm_basic8": ("config2", ("-ksp_type", "gmres", "-pc_type", "asm", "-pc_asm_blocks",
                                  "8", "-pc_asm_type", "basic")),
    "c2_neumann": ("config2_grid", ("-ksp_type", "gmres", "-pc_type", "ilu",
                                    "-pc_factor_trisolve", "neumann")),
    "c2_bjacobi_subksp": ("config2", ("-ksp_type", "fgmres", "-pc_type", "bjacobi",
                                      "-pc_bjacobi_blocks", "4", "-sub_ksp_type", "gmres",
                                      "-sub_pc_type", "ilu")),
    "box_composite": ("box", ("-ksp_type", "cg", "-pc_type", "composite",
                              "-pc_composite_type", "additive", "-pc_composite_pcs",
                              "jacobi,sor")),
    "box_pcksp": ("box", ("-ksp_type", "fgmres", "-pc_type", "ksp", "-ksp_ksp_type", "cg",
                          "-ksp_pc_type", "jacobi", "-ksp_ksp_rtol", "1e-2",
                          "-ksp_ksp_max_it", "20")),
    "box_classical": ("box", ("-ksp_type", "cg", "-pc_type", "gamg", "-pc_gamg_type",
                              "classical")),
    "ex56_fieldsplit": ("ex56", ("-ksp_type", "cg", "-pc_type", "fieldsplit",
                                 "-pc_fieldsplit_type", "additive",
                                 "-fieldsplit_0_pc_type", "gamg", "-fieldsplit_1_pc_type",
                                 "gamg", "-fieldsplit_2_pc_type", "gamg")),
    "matis_bddc": ("matis", ("-ksp_type", "cg", "-pc_type", "bddc")),
    "matis_fetidp": ("matis", ("-ksp_type", "fetidp",)),
    "matis_nn": ("matis_nn", ("-ksp_type", "cg", "-pc_type", "nn")),
}
PC_RTOL = {"config2": 1e-8, "config2_grid": 1e-8, "box": 1e-8, "ex56": 1e-4, "matis": 1e-8,
           "matis_nn": 1e-8}
PC_MAX_IT = {"config2": 400, "config2_grid": 400, "box": 3000, "ex56": 200, "matis": 400,
             "matis_nn": 400}
PC_MATIS = (512, 16)           # ne, subdomains per side: 261,121 dofs, 256 of <= 1,089
PC_MATIS_NN = (256, 8)         # 66,049 dofs, 64 subdomains of <= 1,089
PC_MATIS_SEED = 21
PC_HIST_TOL = 1e-6
# NN's 143 CG steps at rtol 1e-8 are rounding-chaotic past about 45: the
# port on the CPU holds the reference's history to 7.6e-11 over the first
# 40 entries and drifts 2.4e-3 by the 50th (summation order; the count,
# the reason and the true relres still agree). Its history is held over
# those 40 entries, as ex2's GMRES(5) case holds its first 50 lines.
PC_HIST_PREFIX = {"matis_nn": 40}


def pc_rhs_matis(n):
    """The MatIS cases' right-hand side: uniform on [0, 1) from PC_MATIS_SEED
    (b = 1 is symmetric on a symmetric partition, where fetidp's dual
    residual starts at rounding)."""
    import numpy as np
    return np.random.default_rng(PC_MATIS_SEED).random(n)


DATA = Path(__file__).resolve().parent / "tests" / "data"
FIXTURES = ("LFAT5.mtx", "m_05_05_crk.mtx", "amesos2_test_mat0.mtx")


def kernel_modules():
    """The port's kernel wrapper modules, each with its LAUNCHES counts."""
    from petsc_tpu_torch.ops import (block_kernels, gather_kernels, grid_kernels,
                                     pallas_kernels, particle_kernels, pc_kernels, trisolve)
    return (pallas_kernels, gather_kernels, grid_kernels, trisolve, block_kernels, pc_kernels,
            particle_kernels)


def reset_launches():
    """Every kernel's launch count set to 0."""
    for m in kernel_modules():
        m.reset_launches()


def launch_counts():
    """Every kernel's launches since the last reset_launches()."""
    return {k: v for m in kernel_modules() for k, v in m.LAUNCHES.items()}


def emit(obj):
    print(json.dumps(obj), flush=True)


def rel_err(a, b):
    """max |a - b| / max |b|, in float64."""
    a, b = a.double(), b.double()
    den = float(b.abs().max())
    return float((a - b).abs().max()) / (den if den > 0 else 1.0)


class L2Flush:
    """Empties the 50 MB L2 before a timed launch. The clean flush (the
    default) writes one buffer twice the L2's size and then reads a second
    one, so the L2 holds only clean lines when the timed kernel starts and
    its own reads evict nothing that must be written back. The dirty flush
    only writes, which leaves the L2 full of dirty lines whose write-backs
    then fall inside the timed window (kept to compare the two)."""

    def __init__(self, clean=True):
        import torch
        n = 2 * 50 * 2 ** 20 // 4
        self.clean = clean
        self.wbuf = torch.empty(n, dtype=torch.float32, device="cuda")
        self.rbuf = torch.zeros(n, dtype=torch.float32, device="cuda") if clean else None

    def __call__(self):
        self.wbuf.zero_()
        if self.clean:
            self.rbuf.sum()


def time_ms(fn, flush, reps=REPS):
    """Median of `reps` launches of fn(), each timed with CUDA events after
    flush() emptied the L2. The card then spins for about 0.1 ms, so the
    host has queued fn() before the first event is reached and its launch
    time stays out of the window."""
    import torch
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush()
        torch.cuda._sleep(SLEEP_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(e0.elapsed_time(e1) for e0, e1 in pairs)


def bound(nbytes, flops, dtype_name):
    """Least time in ms the card could take: the larger of bytes over the
    memory rate and flops over the type's peak rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(pk, sb, flush, triad_Bps):
    """Check and time every kernel; returns (details, rows at the main
    path's shapes keyed by kernel name)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    details, main = [], {}

    def record(name, dtype, n, err, ms, plain_ms, nbytes, flops, library_ms=None, **extra):
        dn = str(dtype).replace("torch.", "")
        tol = TOL[dn]
        if not err <= tol:
            raise AssertionError(f"{name} {dn} n={n}: kernel vs plain rel err {err} > {tol}")
        b_ms, b_by = bound(nbytes, flops, dn)
        row = {"name": name, "dtype": dn, "n": n, "rel_err": err, "tol": tol,
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": b_ms, "bound_by": b_by,
               "bound_triad_ms": nbytes / triad_Bps * 1e3, **extra}
        details.append(row)
        return row

    # K1 probe (16, 128) f32
    x = torch.rand((16, 128), generator=gen, device=dev)
    err = rel_err(pk.probe(x), pk.probe_plain(x))
    ms = time_ms(lambda: pk.probe(x), flush)
    pms = time_ms(lambda: pk.probe_plain(x), flush)
    main["probe"] = record("probe", torch.float32, x.numel(), err, ms, pms,
                           2 * x.numel() * 4, x.numel())
    main["probe"]["max_abs_err"] = float((pk.probe(x) - pk.probe_plain(x)).abs().max())

    for dtype in (torch.float64, torch.float32):
        isz = torch.empty((), dtype=dtype).element_size()
        for n in ((1 << 24) + 37, N_MAIN ** 3):
            b = torch.rand(n, generator=gen, device=dev, dtype=dtype)
            c = torch.rand(n, generator=gen, device=dev, dtype=dtype)
            alpha = torch.tensor(-0.37, dtype=dtype, device=dev)
            af = float(alpha)
            is_main = dtype == torch.float64 and n == N_MAIN ** 3

            k = pk.triad(b, c, alpha)
            p = pk.triad_plain(b, c, alpha)
            row = record("triad", dtype, n, rel_err(k, p),
                         time_ms(lambda: pk.triad(b, c, alpha), flush),
                         time_ms(lambda: pk.triad_plain(b, c, alpha), flush),
                         3 * n * isz, 2 * n,
                         library_ms=time_ms(lambda: torch.add(b, c, alpha=af), flush))
            if is_main:
                main["triad"] = dict(row, max_abs_err=float((k - p).abs().max()),
                                     design=DESIGN["triad"],
                                     launch=pk.launch_config("triad", dtype, n, dev))

            kv, kn = pk.axpy_normsq(alpha, b, c)
            pv, pn = pk.axpy_normsq_plain(alpha, b, c)
            err = max(rel_err(kv, pv), rel_err(kn, pn))
            row = record("axpy_normsq", dtype, n, err,
                         time_ms(lambda: pk.axpy_normsq(alpha, b, c), flush),
                         time_ms(lambda: pk.axpy_normsq_plain(alpha, b, c), flush),
                         3 * n * isz, 4 * n,
                         norm_rel_err=rel_err(kn, pn))
            if is_main:
                main["axpy_normsq"] = dict(row, max_abs_err=max(
                    float((kv - pv).abs().max()), float((kn - pn).abs())))

            k1, k2 = pk.dot2(b, c)
            p1, p2 = pk.dot2_plain(b, c)
            err = max(rel_err(k1, p1), rel_err(k2, p2))
            row = record("dot2", dtype, n, err,
                         time_ms(lambda: pk.dot2(b, c), flush),
                         time_ms(lambda: pk.dot2_plain(b, c), flush),
                         2 * n * isz, 4 * n,
                         same_bytes_ms=time_ms(lambda: torch.dot(b, c), flush),
                         same_bytes_call="torch.dot(x, y): the same bytes, one of the two sums")
            if is_main:
                main["dot2"] = dict(row, max_abs_err=max(
                    float((k1 - p1).abs()), float((k2 - p2).abs())),
                    design=DESIGN["dot2"], launch=pk.launch_config("dot2", dtype, n, dev))
            del b, c

    # S1 stencil at 128^3, box and star, on both load paths: x aligned (the
    # TMA ring) and x one element past a 16-byte edge (the cp.async ring),
    # each equal to its plain version bit for bit; F.conv3d is the library
    # yardstick
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    shape = (N_MAIN,) * 3
    n = N_MAIN ** 3
    s1 = {}
    for dtype in (torch.float64, torch.float32):
        isz = torch.empty((), dtype=dtype).element_size()
        buf = torch.rand(n + 1, generator=gen, device=dev, dtype=dtype)
        for kind in ("box", "star"):
            is_box = kind == "box"
            cd, co = (26.0, -1.0) if is_box else (6.0, -1.0)
            times = {}
            for x in (buf[:n], buf[1:]):
                path = pk.const_stencil_plan(shape, dtype, x.data_ptr())["path"]
                k = pk.const_stencil(x, shape, cd, co, is_box)
                p = pk.const_stencil_plain(x, shape, cd, co, is_box)
                torch.cuda.synchronize()
                if not torch.equal(k, p):
                    raise AssertionError(f"const_stencil {kind} {dtype} on the {path} path "
                                         "differs from its plain version")
                times[path] = time_ms(lambda: pk.const_stencil(x, shape, cd, co, is_box), flush)
            if set(times) != {"tma", "cp.async"}:
                raise AssertionError(f"const_stencil at 128^3 took the paths {sorted(times)}")
            x = buf[:n]
            w = torch.full((3, 3, 3), co, dtype=dtype, device=dev)
            if not is_box:
                mask = torch.zeros((3, 3, 3), dtype=torch.bool, device=dev)
                mask[1, 1, :] = mask[1, :, 1] = mask[:, 1, 1] = True
                w = torch.where(mask, w, torch.zeros((), dtype=dtype, device=dev))
            w[1, 1, 1] = cd
            w = w.view(1, 1, 3, 3, 3)
            x5 = x.view(1, 1, *shape)
            lib = F.conv3d(x5, w, padding=1).reshape(-1)
            k = pk.const_stencil(x, shape, cd, co, is_box)
            p = pk.const_stencil_plain(x, shape, cd, co, is_box)
            row = record(f"const_stencil_{kind}", dtype, n, rel_err(k, p), times["tma"],
                         time_ms(lambda: pk.const_stencil_plain(x, shape, cd, co, is_box), flush),
                         2 * n * isz, (29 if is_box else 11) * n,
                         library_ms=time_ms(lambda: F.conv3d(x5, w, padding=1), flush),
                         library_rel_err=rel_err(lib, p), bit_equal=True,
                         cp_async_path_ms=times["cp.async"])
            s1[(kind, row["dtype"])] = row
            if is_box and dtype == torch.float64:
                main["const_stencil"] = dict(
                    row, max_abs_err=float((k - p).abs().max()), design=DESIGN["const_stencil"],
                    launch=pk.const_stencil_plan(shape, dtype, x.data_ptr(), dev))
        del buf
    main["const_stencil"]["others"] = {
        f"{kind}_{dn}": {key: r[key] for key in ("ms", "cp_async_path_ms", "plain_ms",
                                                  "library_ms", "bound_ms")}
        for (kind, dn), r in s1.items() if (kind, dn) != ("box", "float64")}

    # the box kernel against a scipy CSR product at 24^3
    A = sb.poisson3d_27pt(24)
    xs = np.random.default_rng(7).random(24 ** 3)
    k = pk.const_stencil(torch.as_tensor(xs, device=dev), (24,) * 3, 26.0, -1.0, True)
    err = rel_err(k.cpu(), torch.as_tensor(A @ xs))
    if not err <= 1e-12:
        raise AssertionError(f"const_stencil vs scipy CSR at 24^3: rel err {err}")
    details.append({"name": "const_stencil_box_vs_scipy_csr", "n": 24 ** 3, "rel_err": err})
    # W1 and W2 on their edge cases (clamps, cell edges, every dim, six fields)
    details.extend(cic_edge_checks())
    return details, main


def phase_flush(pk, flushes):
    """K2, torch.add, K3, K4, torch.dot(x, y) and S1 (box) at 128^3 in f64
    and f32, each timed under every flush of `flushes` (name -> L2Flush),
    the flushes in turns for each function. torch.dot reads the same bytes
    as K4 but computes one of its two sums: a yardstick for the bytes."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(99)
    shape, n = (N_MAIN,) * 3, N_MAIN ** 3
    out = []
    for dtype in (torch.float64, torch.float32):
        b = torch.rand(n, generator=gen, device=dev, dtype=dtype)
        c = torch.rand(n, generator=gen, device=dev, dtype=dtype)
        alpha = torch.tensor(-0.37, dtype=dtype, device=dev)
        af = float(alpha)
        fns = {"triad": lambda: pk.triad(b, c, alpha),
               "torch.add": lambda: torch.add(b, c, alpha=af),
               "axpy_normsq": lambda: pk.axpy_normsq(alpha, b, c),
               "dot2": lambda: pk.dot2(b, c),
               "torch.dot": lambda: torch.dot(b, c),
               "const_stencil_box": lambda: pk.const_stencil(b, shape, 26.0, -1.0, True)}
        for name, fn in fns.items():
            out.append({"name": name, "dtype": str(dtype).replace("torch.", ""), "n": n,
                        **{f"{fl}_ms": time_ms(fn, flush) for fl, flush in flushes.items()}})
        del b, c
    return out


def solve_once(pt, sb, pc_type):
    """The main path through the user's entry points: returns (ksp, A, b, x)."""
    pt.init(args=["-ksp_type", "cg", "-pc_type", pc_type, "-ksp_rtol", "1e-8",
                  "-ksp_max_it", "3000"])
    meta, data = sb.build_dnd((N_MAIN,) * 3, kind="box")
    A = sb.as_mat(meta, data)
    ksp = pt.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    b = A.createVecLeft()
    b.set(1.0)
    x = A.createVecRight()
    ksp.solve(b, x)
    return ksp, A, b, x


def check_solve(pk, ksp, b, x):
    import torch
    its = ksp.getIterationNumber()
    reason = ksp.getConvergedReason().name
    relres = ksp.getResidualNorm() / ksp._rnorm0
    Ax = pk.const_stencil_plain(x.array, (N_MAIN,) * 3, 26.0, -1.0, True)
    true_rel = float(torch.linalg.vector_norm(b.array - Ax) / torch.linalg.vector_norm(b.array))
    if its != ITS_MAIN or reason != "CONVERGED_RTOL" or not relres <= 1e-8 \
            or not true_rel <= 1e-7:
        raise AssertionError(f"128^3 CG: its {its} (want {ITS_MAIN}), {reason}, relres {relres}, "
                             f"true relres {true_rel}")
    if not bool(torch.isfinite(x.array).all()):
        raise AssertionError("solution has non-finite entries")
    return its, reason, relres, true_rel


def warm_ms(ksp, b, x, reps=3):
    """Best of `reps` warm solves, CUDA events around ksp.solve."""
    import torch
    best = math.inf
    for _ in range(reps):
        x.set(0.0)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        ksp.solve(b, x)
        e1.record()
        e1.synchronize()
        best = min(best, e0.elapsed_time(e1))
    return best


def profile_solve(ksp, b, x, warm_ms_best, q1_levels=None):
    """One warm solve under torch.profiler: device busy time (the sum of
    the card's kernel and copy durations; one stream, so they do not
    overlap), its share of the unprofiled warm time, and time by kernel.
    With q1_levels (the Q1 levels' fine grids, finest first) also Q1R's
    and Q1P's µs per launch on each level: a V-cycle restricts from the
    finest level down and prolongates from the coarsest up, one launch per
    level, so the n-th launch in time order belongs to level n mod levels
    (Q1P's counted from the coarsest)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    # the profiler drops the card's first events after it starts, more of
    # them the longer the process has run (on an H100 in one run of this
    # script: none of twenty 1 ms spins lost in the first profile, sixteen
    # in the ninth, all twenty in a later one), as if the card's timestamps
    # drifted against the host's clock. Spin kernels on each side of the
    # solve absorb that and are left out of the counts below; one seen on
    # each side shows that none of the solve's events was lost. Where a
    # profile keeps fewer than half its leading spins, the later ones take
    # twice as many; where it keeps none, the solve is profiled again with
    # the larger count (at most twice more).
    for _attempt in range(3):
        spins_each_side = _SPINS[0]
        x.set(0.0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(spins_each_side):
                torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ksp.solve(b, x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            for _ in range(WARMUP_SPINS):
                torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        by_name, q1_events = {}, {"q1_restrict": [], "q1_prolong": []}
        spins, span = [], [math.inf, -math.inf]
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA and "spin_kernel" in ev.name:
                spins.append(ev.time_range.start)
            elif ev.device_type == DeviceType.CUDA:
                span = [min(span[0], ev.time_range.start), max(span[1], ev.time_range.end)]
                n, us = by_name.get(ev.name, (0, 0.0))
                by_name[ev.name] = (n + 1, us + ev.time_range.elapsed_us())
                for name in q1_events:
                    if any(key in ev.name for key in IN_SOLVE[name]):
                        q1_events[name].append((ev.time_range.start, ev.time_range.elapsed_us()))
        lead = sum(1 for t in spins if t < span[0])
        trail = sum(1 for t in spins if t > span[1])
        if 2 * lead < spins_each_side:
            _SPINS[0] = 2 * spins_each_side
        if lead and trail:
            break
    else:
        raise AssertionError(f"the profiler kept {lead} of the {spins_each_side} spin kernels "
                             f"before the solve and {trail} of {WARMUP_SPINS} after it: it may "
                             "have lost some of the solve's own events")
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    in_solve = {}
    for name, keys in IN_SOLVE.items():
        hits = [(n, us) for k, (n, us) in by_name.items() if any(key in k for key in keys)]
        count = sum(n for n, _ in hits)
        if count:
            in_solve[name] = {"launches": count, "ms": sum(us for _, us in hits) / 1e3,
                              "us_per_launch": sum(us for _, us in hits) / count}
    per_level = {}
    if q1_levels:
        nlev = len(q1_levels)
        for name, evs in q1_events.items():
            if not evs or len(evs) % nlev:
                raise AssertionError(f"{len(evs)} {name} launches in the solve, not a positive "
                                     f"multiple of its {nlev} Q1 levels")
            order = q1_levels if name == "q1_restrict" else q1_levels[::-1]
            us = [e[1] for e in sorted(evs)]
            per_level[name] = {"x".join(map(str, order[k])): {
                "launches": len(us[k::nlev]), "us_per_launch": sum(us[k::nlev]) / len(us[k::nlev])}
                for k in range(nlev)}
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "spins_seen_before_and_after": [lead, trail], "spins_before": spins_each_side,
            "busy_share_of_warm": busy_ms / warm_ms_best if by_name else None,
            "q1_per_level": per_level,
            "device_events": sum(n for n, _ in by_name.values()),
            "in_solve": in_solve,
            "by_kernel": [{"name": k[:90], "count": n, "ms": us / 1e3}
                          for k, (n, us) in top]}


def check_one_launch(prof, its):
    """K4 is one launch: the only second passes (sum_partials) in a solve
    are K3's, one per iteration."""
    sp = prof["in_solve"].get("sum_partials", {}).get("launches", 0)
    if sp != its:
        raise AssertionError(f"the solve launched {sp} sum_partials, want {its} (K3's only)")


def distinct(flat_idx, n):
    """How many distinct entries of an n-entry array flat_idx names."""
    import torch
    seen = torch.zeros(n, dtype=torch.bool, device=flat_idx.device)
    seen[flat_idx.reshape(-1).long()] = True
    return int(seen.sum())


def sector_bytes(flat_idx, n, itemsize):
    """The bytes of the 32-byte sectors of an n-entry array of itemsize
    bytes that flat_idx touches: the least a gather of those entries moves
    (K8's bound)."""
    return 32 * distinct(flat_idx.long() * itemsize // 32, (n * itemsize + 31) // 32)


def unique_values(count, dtype, device):
    """count entries of dtype with distinct bit patterns (an integer arange
    viewed as dtype; no NaN or infinity below 2^31): a gather that reads a
    wrong entry cannot compare equal."""
    import torch
    bits = torch.int64 if dtype == torch.float64 else torch.int32
    return torch.arange(count, dtype=bits, device=device).view(dtype)


def gather_row(name, dtype, check_args, time_args, kern, plain, library, nbytes, elems,
               flush):
    """Holds gather kernel `kern` against its plain version bit for bit on
    check_args (whose values are unique per entry), then times the kernel,
    the plain version and the library call on time_args."""
    import torch
    dn = str(dtype).replace("torch.", "")
    bits = torch.int64 if dtype == torch.float64 else torch.int32
    k, p = kern(*check_args), plain(*check_args)
    torch.cuda.synchronize()
    if k.shape != p.shape or not torch.equal(k.view(bits), p.view(bits)):
        raise AssertionError(f"{name} {dn}: kernel differs from its plain version")
    b_ms, b_by = bound(nbytes, 0, dn)
    row = {"name": name, "dtype": dn, "elements": elems, "bit_equal": True,
           "max_abs_err": float((k.double() - p.double()).abs().max()),
           "ms": time_ms(lambda: kern(*time_args, check=False), flush),
           "plain_ms": time_ms(lambda: plain(*time_args), flush),
           "library_ms": time_ms(library, flush),
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
    row["Gelem_per_s"] = elems / row["ms"] / 1e6
    return row


def phase_gather(gk, flush):
    """K5-K8 at the Pallas probes' shapes (examples/pallas_shuffle_probe.py
    probe_s1/s2/s3, examples/pallas_gather_probe.py probe_g1), each equal to
    its plain version bit for bit on values unique per entry, and timed on
    the probes' own values. Returns (details, f64 rows by name)."""
    import torch
    dev = torch.device("cuda")
    details, main = [], {}
    C, B, W = PROBE_SHUFFLE
    n8, m8 = PROBE_GATHER
    for dtype in (torch.float64, torch.float32):
        isz = torch.empty((), dtype=dtype).element_size()
        gen = torch.Generator(device=dev).manual_seed(0)

        def probe_values(count, period):
            return (0.5 + (torch.arange(count, device=dev) % period) / period).to(dtype)

        def ints(hi, shape):
            return torch.randint(0, hi, shape, generator=gen, device=dev, dtype=torch.int32)

        def record(name, check_args, time_args, kern, plain, library, nbytes, elems):
            row = gather_row(name, dtype, check_args, time_args, kern, plain, library,
                             nbytes, elems, flush)
            details.append(row)
            if dtype == torch.float64:
                main[name] = row

        # K5 lane shuffle: o[r, l] = V[r, s[r, l]]
        V = probe_values(C * W, 997).view(C, W)
        Vu = unique_values(C * W, dtype, dev).view(C, W)
        s = ints(W, (C, W))
        s_l = s.long()
        nd = distinct(torch.arange(C, device=dev)[:, None] * W + s, C * W)
        record("lane_shuffle", (Vu, s), (V, s), gk.lane_shuffle, gk.lane_shuffle_plain,
               lambda: torch.take_along_dim(V, s_l, 1), C * W * (4 + isz) + nd * isz, C * W)
        del V, Vu, s, s_l

        # K6 row gather: o[c, :] = x2[q[c], :]
        x2 = probe_values(B * W, 997).view(B, W)
        x2u = unique_values(B * W, dtype, dev).view(B, W)
        q = ints(B, (C,))
        nd = distinct(q, B) * W
        record("row_gather", (x2u, q), (x2, q), gk.row_gather, gk.row_gather_plain,
               lambda: torch.index_select(x2, 0, q), C * 4 + C * W * isz + nd * isz, C * W)
        del q

        # K7 two-level gather: o[c, l] = x2.flat[128 q[c, l] + s[c, l]]
        q = ints(B, (C, W))
        s = ints(W, (C, W))
        x2f = x2.view(-1)
        nd = distinct(q * W + s, B * W)
        record("gather2", (x2u, q, s), (x2, q, s), gk.gather2, gk.gather2_plain,
               lambda: x2f[128 * q + s], C * W * (8 + isz) + nd * isz, C * W)
        del q, s, x2, x2u, x2f

        # K8 flat gather: o = x[idx], idx viewed (m / 128, 128); the bound
        # counts the 32-byte sectors of x read
        x = probe_values(n8, 1000)
        xu = unique_values(n8, dtype, dev)
        idx = ints(n8, (m8 // 128, 128))
        idx_l = idx.long()
        record("gather", (xu, idx), (x, idx), gk.gather, gk.gather_plain,
               lambda: torch.take(x, idx_l), m8 * (4 + isz) + sector_bytes(idx, n8, isz), m8)
        del x, xu, idx, idx_l
        torch.cuda.empty_cache()
    return details, main


def phase_coo_gather(gk, A, cv, flush):
    """K8 at the two shapes the assembled path gives it, after
    setValuesCOO: the CSR values must equal v[perm] (the box27 pattern has
    no repeated entry, so no sum follows) and the diagonal csr_vals[diag_pos]
    (0 where a row has none), and the kernel must equal its plain version
    bit for bit at both shapes on values unique per entry; each is timed
    on the path's own values. The bound counts the indices, the output and
    the 32-byte sectors of the values read: every sector of v for v[perm],
    one sector per diagonal entry (216 bytes apart) for the refresh.
    Returns (the v[perm] row, the diagonal row)."""
    import torch
    dev = torch.device("cuda")
    plan, d = A._coo_plan, A.device_data()
    perm, dpos = plan["perm"], d["diag_pos"]
    v = torch.as_tensor(cv, device=dev)
    if plan["seg"] is not None or not torch.equal(d["vals"], gk.gather_plain(v, perm)):
        raise AssertionError("setValuesCOO: the CSR values differ from v[perm]")
    dpos_c = dpos.clamp(min=0)
    want = torch.where(dpos >= 0, gk.gather_plain(d["vals"], dpos_c),
                       torch.zeros((), dtype=d["vals"].dtype, device=dev))
    if not torch.equal(d["diag"], want) or not bool((d["diag"] == 26.0).all()):
        raise AssertionError("setValuesCOO: the diagonal differs from csr_vals[diag_pos]")
    isz = v.element_size()
    m, nb = perm.numel(), sector_bytes(perm, v.numel(), isz)
    perm_l = perm.long()
    vals_row = gather_row(
        "gather", v.dtype, (unique_values(v.numel(), v.dtype, dev), perm), (v, perm),
        gk.gather, gk.gather_plain, lambda: torch.take(v, perm_l),
        m * (4 + isz) + nb, m, flush)
    del perm_l
    vals, m = d["vals"], dpos_c.numel()
    nb = sector_bytes(dpos_c, vals.numel(), isz)
    dpos_l = dpos_c.long()
    diag_row = gather_row(
        "gather", vals.dtype, (unique_values(vals.numel(), vals.dtype, dev), dpos_c),
        (vals, dpos_c), gk.gather, gk.gather_plain, lambda: torch.take(vals, dpos_l),
        m * (4 + isz) + nb, m, flush)
    del v, dpos_l
    torch.cuda.empty_cache()
    return (dict(vals_row, shape="v[perm]: values (nnz,), perm (nnz,)"),
            dict(diag_row, shape="csr_vals[diag_pos]: values (nnz,), diag_pos (N,)"))


def box27_coo(n):
    """The box27 operator on an n^3 grid as COO triplets in the order of
    examples/bench_kspsolve.py:23-42: the diagonal first, then the 26
    offsets, each in row order (so the whole is not row-sorted)."""
    import numpy as np
    N = n ** 3
    idx = np.arange(N, dtype=np.int64)
    z, r = divmod(idx, n * n)
    y, x = divmod(r, n)
    rows, cols = [idx], [idx]
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if (dx, dy, dz) == (0, 0, 0):
                    continue
                xx, yy, zz = x + dx, y + dy, z + dz
                ok = (xx >= 0) & (xx < n) & (yy >= 0) & (yy < n) & (zz >= 0) & (zz < n)
                rows.append(idx[ok])
                cols.append((zz * n * n + yy * n + xx)[ok])
    i, j = np.concatenate(rows), np.concatenate(cols)
    v = np.full(len(i), -1.0)
    v[:N] = 26.0
    return i, j, v


KAIJ_DT = 0.01                   # the Radau IIA stage system's time step


def radau_iia3():
    """The Butcher matrix of the 3-stage Radau IIA method (order 5)."""
    import numpy as np
    r = math.sqrt(6.0)
    return np.array([[(88 - 7 * r) / 360, (296 - 169 * r) / 1800, (-2 + 3 * r) / 225],
                     [(296 + 169 * r) / 1800, (88 + 7 * r) / 360, (-2 - 3 * r) / 225],
                     [(16 - r) / 36, (16 + r) / 36, 1 / 9]])


def maij_rhs(N):
    """MAIJ's right-hand side, node-major: at node i the components 1,
    cos(0.01 i) and sin(0.01 i)."""
    import numpy as np
    i = np.arange(N, dtype=np.float64)
    return np.stack([np.ones(N), np.cos(0.01 * i), np.sin(0.01 * i)], axis=1).reshape(-1)


def matsolve_rhs(N, k=4):
    """matSolve's (N, k) right-hand sides: column 0 is 1, column c > 0 is
    cos(0.01 (i + c))."""
    import numpy as np
    i = np.arange(N, dtype=np.float64)
    return np.stack([np.ones(N)] + [np.cos(0.01 * (i + c)) for c in range(1, k)], axis=1)


def aij_solve(pt, A, pc_type):
    ksp = pt.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    ksp.getPC().setType(pc_type)
    b = A.createVecLeft()
    b.set(1.0)
    x = A.createVecRight()
    ksp.solve(b, x)
    return ksp, b, x


def check_aij_solve(pk, ksp, A, b, x, hist_stencil):
    import numpy as np
    import torch
    its = ksp.getIterationNumber()
    reason = ksp.getConvergedReason().name
    relres = ksp.getResidualNorm() / ksp._rnorm0
    d = A.device_data()
    Ax = pk.csr_spmv_plain(d["indptr"], d["col"], d["vals"], x.array)
    true_rel = float(torch.linalg.vector_norm(b.array - Ax) / torch.linalg.vector_norm(b.array))
    hist = ksp.getConvergenceHistory()
    hist_rel = (float(np.max(np.abs(hist - hist_stencil) / np.abs(hist_stencil)))
                if hist.shape == hist_stencil.shape else math.inf)
    if its != ITS_MAIN or reason != "CONVERGED_RTOL" or not relres <= 1e-8 \
            or not true_rel <= 1e-7 or not hist_rel <= 1e-6:
        raise AssertionError(f"128^3 CSR CG: its {its} (want {ITS_MAIN}), {reason}, relres {relres}, "
                             f"true relres {true_rel}, history vs stencil {hist_rel}")
    if not bool(torch.isfinite(x.array).all()):
        raise AssertionError("CSR solution has non-finite entries")
    return {"its": its, "reason": reason, "relres": relres, "true_relres": true_rel,
            "history_rel_diff_vs_stencil": hist_rel}


def csr_tile():
    """S2's entries per tile (kTile in csr_spmv.cu, both types)."""
    import re
    src = (Path(__file__).resolve().parent / "petsc_tpu_torch" / "csrc" / "csr_spmv.cu").read_text()
    return int(re.search(r"constexpr int kTile = (\d+);", src).group(1))


def tile_edge_cases(T):
    """CSR row lengths cut around a tile of T entries: rows of T - 1, T and
    T + 1 entries across tile edges, a row of 50 T (positive values, so
    that a float32 sum does not cancel), runs of empty rows at the start,
    middle and end, entries that end on a tile edge before empty rows, and
    no entries at all in 5000 rows."""
    return {f"tile{T}_edges": ([3, T - 1, T, T + 1, 1, T + 1, T, T - 1, 2 * T, 5, T - 1, T - 1,
                                T + 1, T + 1], -0.5),
            f"tile{T}_long_row": ([7, 50 * T, 13, 0, 2], 0.5),
            f"tile{T}_empty_runs": ([0] * 300 + [27] * 200 + [0] * 400 + [T + 1] * 3 + [27] * 100
                                    + [0] * 500, -0.5),
            f"tile{T}_ends_on_an_edge": ([T // 2] * 8 + [0] * 50, -0.5),
            "no_entries_5000_rows": ([0] * 5000, -0.5)}


def phase_spmv_edges(pk):
    """S2 on the tile-edge cases of its tile length, f64 and f32, against
    its plain version run in float64 on the same inputs (1e-12 / 1e-5
    relative), for equal bits on a rerun, and once more with vals and col
    one element past a 16-byte edge. The reference is widened because the
    plain version sums a row with atomic adds in no fixed order: in float32
    that alone moves the long row's sum by up to about 1e-5."""
    import numpy as np
    import torch
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    out = []
    for name, (lengths, low) in tile_edge_cases(csr_tile()).items():
        indptr = np.r_[0, np.cumsum(lengths)].astype(np.int64)
        nnz, n = int(indptr[-1]), 3000
        cols = rng.integers(0, n, nnz).astype(np.int32)
        vals = rng.random(nnz) + low
        xs = rng.random(n)
        for dtype in (torch.float64, torch.float32):
            dn = str(dtype).replace("torch.", "")
            ip = torch.as_tensor(indptr, device=dev)
            c = torch.as_tensor(cols, device=dev)
            v = torch.as_tensor(vals, dtype=dtype, device=dev)
            x = torch.as_tensor(xs, dtype=dtype, device=dev)
            k = pk.csr_spmv(ip, c, v, x)
            p = pk.csr_spmv_plain(ip, c, v.double(), x.double())
            plain_err = rel_err(pk.csr_spmv_plain(ip, c, v, x), p) if nnz else 0.0
            c1 = torch.cat([c[:1], c])[1:]
            v1 = torch.cat([v[:1], v])[1:]
            torch.cuda.synchronize()
            err = rel_err(k, p) if nnz else float(k.abs().max())
            same = torch.equal(k, pk.csr_spmv(ip, c, v, x)) and \
                torch.equal(k, pk.csr_spmv(ip, c1, v1, x))
            if not err <= TOL[dn] or not same:
                raise AssertionError(f"csr_spmv {name} {dn}: rel err {err} (tol {TOL[dn]}), "
                                     f"equal bits on reruns {same}")
            out.append({"name": f"csr_spmv_{name}", "dtype": dn, "rows": len(lengths),
                        "nnz": nnz, "rel_err": err, "plain_rel_err": plain_err,
                        "bit_equal_rerun_and_offset": same})
    return out


def phase_spmv(pt, pk, sb, A, flush):
    """S2 alone: at 128^3 against its plain version (f64 and f32) and
    torch.sparse_csr_tensor, against scipy on the tests/data fixtures and
    at 24^3, and on the tile-edge cases. Returns (details, the f64 128^3
    row)."""
    import numpy as np
    import torch
    from petsc_tpu_torch.mat.mmio import load_matrix_market
    dev = torch.device("cuda")
    d = A.device_data()
    ip, col, nnz, n = d["indptr"], d["col"], A.nnz(), A.getSize()[0]
    gen = torch.Generator(device=dev).manual_seed(4321)
    details, main = [], None
    for dtype in (torch.float64, torch.float32):
        dn = str(dtype).replace("torch.", "")
        isz = torch.empty((), dtype=dtype).element_size()
        vals = d["vals"].to(dtype)
        x = torch.rand(n, generator=gen, device=dev, dtype=dtype)
        k = pk.csr_spmv(ip, col, vals, x)
        p = pk.csr_spmv_plain(ip, col, vals, x)
        err = rel_err(k, p)
        if not err <= TOL[dn]:
            raise AssertionError(f"csr_spmv {dn} at 128^3: rel err {err} > {TOL[dn]}")
        A_lib = torch.sparse_csr_tensor(ip.int(), col, vals, size=(n, n))
        nbytes = nnz * (isz + 4) + (n + 1) * 8 + 2 * n * isz
        b_ms, b_by = bound(nbytes, 2 * nnz, dn)
        row = {"name": "csr_spmv", "dtype": dn, "n": n, "nnz": nnz, "rel_err": err,
               "tol": TOL[dn], "max_abs_err": float((k - p).abs().max()),
               "ms": time_ms(lambda: pk.csr_spmv(ip, col, vals, x), flush),
               "plain_ms": time_ms(lambda: pk.csr_spmv_plain(ip, col, vals, x), flush),
               "library_ms": time_ms(lambda: A_lib @ x, flush),
               "library_rel_err": rel_err(A_lib @ x, p),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
        row["Gnnz_per_s"] = nnz / row["ms"] / 1e6
        row["bound_Gnnz_per_s"] = nnz / b_ms / 1e6
        row["share_of_bound"] = b_ms / row["ms"]
        row["tile_entries"] = csr_tile()
        details.append(row)
        if dtype == torch.float64:
            main = row
        del vals, x, k, p, A_lib
    cases = [(f, load_matrix_market(DATA / f)) for f in FIXTURES]
    cases.append(("box27_24", pt.MatAIJ.from_scipy(sb.poisson3d_27pt(24))))
    for name, M in cases:
        ref = M.to_scipy()
        xs = np.random.default_rng(7).random(ref.shape[1])
        dd = M.device_data()
        y = pk.csr_spmv(dd["indptr"], dd["col"], dd["vals"], torch.as_tensor(xs, device=dev))
        err = rel_err(y.cpu(), torch.as_tensor(ref @ xs))
        if not err <= 1e-12:
            raise AssertionError(f"csr_spmv vs scipy on {name}: rel err {err}")
        details.append({"name": f"csr_spmv_vs_scipy_{name}", "shape": list(ref.shape),
                        "nnz": int(ref.nnz), "rel_err": err})
    details.extend(phase_spmv_edges(pk))
    return details, main


def q1_interp(nf):
    """The 1-D factor-2 vertex interpolation of petsc_tpu/dm/interp.py:21-45
    as a scipy CSR (nf x nc, nc = (nf + 1) // 2): even fine points inject
    their coarse point, odd ones average their two coarse neighbours, and
    for even nf the last odd point takes weight 1 on the last coarse point."""
    import numpy as np
    import scipy.sparse as sp
    nc = (nf + 1) // 2
    i = np.arange(nf)
    j = i // 2
    odd = i % 2 == 1
    two = odd & (j + 1 < nc)
    rows = np.concatenate([i, i[two]])
    cols = np.concatenate([np.where(odd & ~two, nc - 1, j), j[two] + 1])
    vals = np.concatenate([np.where(two, 0.5, 1.0), np.full(int(two.sum()), 0.5)])
    return sp.csr_matrix((vals, (rows, cols)), shape=(nf, nc))


def q1_hierarchy(n, coarsest=8):
    """The grids n, n/2, ... down to `coarsest` and, for each but the last,
    the 3-D interpolation kron(P1, P1, P1) from the next grid (C order)."""
    import scipy.sparse as sp
    grids = [n]
    while grids[-1] > coarsest:
        grids.append(grids[-1] // 2)
    Ps = []
    for nf in grids[:-1]:
        P1 = q1_interp(nf)
        Ps.append(sp.kron(P1, sp.kron(P1, P1)).tocsr())
    return grids, Ps


def mg_ksp(pt, A, Ps):
    """CG + PCMG on A through the user's entry points: options, KSP, the
    PCMG API's levels and interpolations; the coarse operators come from
    the PC's own Galerkin set-up. Returns the KSP, set up."""
    ksp = pt.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    mg = ksp.getPC()._impl
    mg.setLevels(len(Ps) + 1)
    for l, P in enumerate(Ps):
        mg.setInterpolation(l, pt.MatAIJ.from_scipy(P))
    ksp.setUp()
    return ksp


def check_mg_solve(pk, ksp, A, b, x, cycle):
    import numpy as np
    import torch
    its = ksp.getIterationNumber()
    reason = ksp.getConvergedReason().name
    relres = ksp.getResidualNorm() / ksp._rnorm0
    d = A.device_data()
    Ax = pk.csr_spmv_plain(d["indptr"], d["col"], d["vals"], x.array)
    true_rel = float(torch.linalg.vector_norm(b.array - Ax) / torch.linalg.vector_norm(b.array))
    hist, want = ksp.getConvergenceHistory(), np.array(MG_HIST[cycle])
    hist_rel = (float(np.max(np.abs(hist - want) / want)) if hist.shape == want.shape
                else math.inf)
    nnz = [lev.A.nnz() for lev in ksp.getPC()._impl.levels]
    if its != MG_ITS or reason != "CONVERGED_RTOL" or not relres <= 1e-8 \
            or not hist_rel <= MG_HIST_TOL[cycle] or tuple(nnz) != MG_NNZ \
            or not true_rel <= 10 * MG_TRUE_RELRES[cycle]:
        raise AssertionError(
            f"128^3 CG+PCMG ({cycle} cycle): its {its} (want {MG_ITS}), {reason}, relres "
            f"{relres}, history vs the reference {hist_rel} (tol {MG_HIST_TOL[cycle]}), "
            f"level nnz {nnz} (want {list(MG_NNZ)}), true relres {true_rel} "
            f"(the reference's {MG_TRUE_RELRES[cycle]})")
    if not bool(torch.isfinite(x.array).all()):
        raise AssertionError("CG+PCMG solution has non-finite entries")
    return {"its": its, "reason": reason, "relres": relres, "true_relres": true_rel,
            "reference_true_relres": MG_TRUE_RELRES[cycle],
            "history_rel_diff_vs_reference": hist_rel, "level_nnz": nnz}


def mg_launches_needed(its, nlev):
    """The launches of one CG + multigrid solve (PCMG or GAMG: the same cycle)
    with a V-cycle of Chebyshev(2, 2):
    its + 1 PC applications, each with, on every level but the coarsest,
    4 C1 (two per smoothing), 7 S2 (A x and A p per smoothing, the
    residual, the restriction, the prolongation) and 2 K2 (residual and
    correction); CG adds one S2, two K2, one K3 and two K4 per iteration
    and one K4 before them."""
    napply, fine = its + 1, nlev - 1
    return {"cheby_update": 4 * fine * napply, "csr_spmv": 7 * fine * napply + its,
            "triad": 2 * fine * napply + 2 * its, "axpy_normsq": its, "dot2": 1 + 2 * its,
            "const_stencil": 0}


MG_EVENTS = {"download": "PCMGSetUp_download", "native_build": "PCMGSetUp_native",
             "spgemm": "PCMGSetUp_SpGEMM", "emax": "PCMGSetUp_emax", "lu": "PCMGSetUp_LU",
             "pc_setup_total": "PCSetUp_mg"}
GAMG_EVENTS = {k: f"PCGAMGSetUp_{k}" for k in ("download", "native", "graph", "coarsen",
                                               "prol0", "emax", "smooth_prol", "SpGEMM")}
GAMG_EVENTS.update(lu="PCMGSetUp_LU", pc_setup_total="PCSetUp_gamg")


def setup_seconds(pt, events):
    """The host seconds of the last set-up, from the profiler's events
    (name in the record -> event name)."""
    out = {}
    for key, ev in events.items():
        e = pt.log().get_event(ev)
        out[key] = e.time if e is not None else 0.0
    return out


def check_mg_spmv(pk, ksp, flush):
    """S2 against its plain version, computed in float64, on every operator
    the cycle multiplies by (each level's A, P and R, in the cycle's own
    type), each timed after the clean flush. Call it after the launch
    counts were read: these launches are no part of the path's count."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(99)
    levels = ksp.getPC().device_data()["levels"][:-1]
    rows = []
    for l, ld in enumerate(levels):
        n, nc = ld["A"]["indptr"].numel() - 1, ld["R"]["indptr"].numel() - 1
        for op, ncols in (("A", n), ("P", nc), ("R", n)):
            ip, col, vals = ld[op]["indptr"], ld[op]["col"], ld[op]["vals"]
            dn = str(vals.dtype).replace("torch.", "")
            x = torch.rand(ncols, generator=gen, device=dev, dtype=vals.dtype)
            k = pk.csr_spmv(ip, col, vals, x)
            p = pk.csr_spmv_plain(ip, col, vals.double(), x.double())
            err = rel_err(k, p)
            m, nnz = ip.numel() - 1, vals.numel()
            if not err <= TOL[dn]:
                raise AssertionError(f"csr_spmv on level {l} {op} ({m} x {ncols}, {dn}): "
                                     f"rel err {err} > {TOL[dn]}")
            isz = vals.element_size()
            nbytes = nnz * (isz + 4) + (m + 1) * 8 + (m + ncols) * isz
            b_ms, b_by = bound(nbytes, 2 * nnz, dn)
            rows.append({"level": l, "op": op, "dtype": dn, "rows": m, "cols": ncols,
                         "nnz": nnz, "rel_err": err, "tol": TOL[dn],
                         "max_abs_err": float((k.double() - p).abs().max()),
                         "ms": time_ms(lambda: pk.csr_spmv(ip, col, vals, x), flush),
                         "bound_ms": b_ms, "bound_by": b_by})
    return rows


def run_cycle(pt, pk, A, args, make_ksp, check, events, flush):
    """One CG + multigrid solve on A through the user's entry points: every
    launch count set to 0 just before init and read just after the solve,
    the solve checked (check(ksp, b, x) returns the record or raises), the
    launches held to mg_launches_needed, S2 held against float64 on every
    operator of the cycle, the warm solve timed and checked again. Returns
    (ksp, b, x, warm ms, launches, the record)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live0 = torch.cuda.memory_allocated()
    reset_launches()
    pt.init(args=args)
    pt.log().reset()
    t0 = time.perf_counter()
    ksp = make_ksp()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    b = A.createVecLeft()
    b.set(1.0)
    x = A.createVecRight()
    t1 = time.perf_counter()
    ksp.solve(b, x)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t1
    launches = launch_counts()
    chk = check(ksp, b, x)
    nlev = len(ksp.getPC()._impl.levels)
    need = mg_launches_needed(chk["its"], nlev)
    bad = {k: (launches[k], v) for k, v in need.items() if launches[k] != v}
    if bad:
        raise AssertionError(f"{args}: launches (got, want): {bad}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    path = (torch.cuda.max_memory_allocated() - live0) / 2 ** 20
    spmv_rows = check_mg_spmv(pk, ksp, flush)
    warm = warm_ms(ksp, b, x)
    check(ksp, b, x)
    rec = {**chk, "setup_s": setup_s, "setup_split_s": setup_seconds(pt, events),
           "first_solve_s": first_s, "warm_ms_best_of_3": warm,
           "ms_per_it": warm / chk["its"], "launches": launches, "launches_needed": need,
           # the cycle's own: CG's S2 and K2 launches taken out
           "launches_per_pc_apply": {
               "cheby_update": launches["cheby_update"] / (chk["its"] + 1),
               "csr_spmv": (launches["csr_spmv"] - chk["its"]) / (chk["its"] + 1),
               "triad": (launches["triad"] - 2 * chk["its"]) / (chk["its"] + 1)},
           "emax": [lev.emax for lev in ksp.getPC()._impl.levels],
           "peak_mem_MiB": peak, "path_peak_mem_MiB": path, "csr_spmv_checks": spmv_rows}
    return ksp, b, x, warm, launches, rec


def phase_mg(pt, pk, A, smi, t_start, flush):
    """CG + PCMG on the assembled 128^3 operator, f64 and f32 cycles, each
    building its own hierarchy (run_cycle). Returns (the phase's record,
    the f64 KSP, b, x, its warm ms, its launches)."""
    grids, Ps = q1_hierarchy(N_MAIN)
    if tuple(grids) != MG_GRIDS:
        raise AssertionError(f"hierarchy grids {grids}, want {MG_GRIDS}")
    out = {"phase": "mg", "n": N_MAIN, "stencil": "box27", "assembly": "COO", "rtol": 1e-8,
           "grids": grids, "smoother": "chebyshev(2,2)/jacobi", "coarse": "dense LU",
           "nvidia_smi": smi}
    res = {}
    for cycle in ("f64", "f32"):
        args = ["-ksp_type", "cg", "-pc_type", "mg", "-ksp_rtol", "1e-8"]
        if cycle == "f32":
            args += ["-pc_mg_dtype", "single"]
        *res[cycle], out[cycle] = run_cycle(
            pt, pk, A, args, lambda: mg_ksp(pt, A, Ps),
            lambda ksp, b, x, cycle=cycle: check_mg_solve(pk, ksp, A, b, x, cycle),
            MG_EVENTS, flush)
    out["seconds_so_far"] = time.perf_counter() - t_start
    return (out, *res["f64"])


def gamg_ksp(pt, A):
    """CG + GAMG on A through the user's entry points (the options of
    init), set up."""
    ksp = pt.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    ksp.setUp()
    return ksp


def check_gamg_solve(pk, ksp, A, b, x, cycle):
    """The reference's 128^3 CG+GAMG contract (GAMG_* constants): its,
    reason, relres, history, the hierarchy (rows, nnz of A and P, aggregate
    counts, the level-0 aggregates' hash, each Chebyshev bound) and a true
    residual no worse than 10x the reference's."""
    import hashlib
    import numpy as np
    import torch
    its = ksp.getIterationNumber()
    reason = ksp.getConvergedReason().name
    relres = ksp.getResidualNorm() / ksp._rnorm0
    d = A.device_data()
    Ax = pk.csr_spmv_plain(d["indptr"], d["col"], d["vals"], x.array)
    true_rel = float(torch.linalg.vector_norm(b.array - Ax) / torch.linalg.vector_norm(b.array))
    hist, want = ksp.getConvergenceHistory(), np.array(GAMG_HIST[cycle])
    hist_rel = (float(np.max(np.abs(hist - want) / want)) if hist.shape == want.shape
                else math.inf)
    levels = ksp.getPC()._impl.levels
    hier = {"rows": [lev.A.getSize()[0] for lev in levels],
            "nnz": [lev.A.nnz() for lev in levels],
            "P_nnz": [int(lev.P.to_scipy().nnz) for lev in levels[:-1]],
            "aggregates": [int(lev.agg.max()) + 1 for lev in levels[:-1]],
            "agg0_sha256": hashlib.sha256(np.asarray(levels[0].agg, dtype=np.int64)
                                          .tobytes()).hexdigest(),
            "emax": [lev.emax for lev in levels[:-1]]}
    emax_rel = (max(abs(a - b) / b for a, b in zip(hier["emax"], GAMG_EMAX))
                if len(hier["emax"]) == len(GAMG_EMAX) else math.inf)
    want_hier = {"rows": list(GAMG_ROWS), "nnz": list(GAMG_NNZ), "P_nnz": list(GAMG_P_NNZ),
                 "aggregates": list(GAMG_AGGS), "agg0_sha256": GAMG_AGG0_SHA256}
    bad_hier = {k: (hier[k], v) for k, v in want_hier.items() if hier[k] != v}
    if its != GAMG_ITS or reason != "CONVERGED_RTOL" or not relres <= 1e-8 \
            or not hist_rel <= MG_HIST_TOL[cycle] or bad_hier or not emax_rel <= 1e-12 \
            or not true_rel <= 10 * GAMG_TRUE_RELRES[cycle]:
        raise AssertionError(
            f"128^3 CG+GAMG ({cycle} cycle): its {its} (want {GAMG_ITS}), {reason}, relres "
            f"{relres}, history vs the reference {hist_rel} (tol {MG_HIST_TOL[cycle]}), "
            f"hierarchy (got, want) {bad_hier}, emax vs the reference {emax_rel} (tol 1e-12), "
            f"true relres {true_rel} (the reference's {GAMG_TRUE_RELRES[cycle]})")
    if not bool(torch.isfinite(x.array).all()):
        raise AssertionError("CG+GAMG solution has non-finite entries")
    return {"its": its, "reason": reason, "relres": relres, "true_relres": true_rel,
            "reference_true_relres": GAMG_TRUE_RELRES[cycle],
            "history_rel_diff_vs_reference": hist_rel, "emax_rel_diff_vs_reference": emax_rel,
            "hierarchy": hier}


def phase_gamg(pt, pk, A, smi, t_start, flush):
    """CG + GAMG (smoothed aggregation, every GAMG option at its default) on
    the assembled 128^3 operator, f64 and f32 cycles, each setting up its
    own hierarchy (run_cycle). Returns (the phase's record, the f64 KSP, b,
    x, its warm ms, its launches)."""
    out = {"phase": "gamg", "n": N_MAIN, "stencil": "box27", "assembly": "COO", "rtol": 1e-8,
           "coarsening": "MIS-2 + square fix on level 0, MIS above, threshold -1",
           "smoother": "chebyshev(2,2)/jacobi", "coarse": "dense LU", "nvidia_smi": smi}
    res = {}
    for cycle in ("f64", "f32"):
        args = ["-ksp_type", "cg", "-pc_type", "gamg", "-ksp_rtol", "1e-8"]
        if cycle == "f32":
            args += ["-pc_mg_dtype", "single"]
        *res[cycle], out[cycle] = run_cycle(
            pt, pk, A, args, lambda: gamg_ksp(pt, A),
            lambda ksp, b, x, cycle=cycle: check_gamg_solve(pk, ksp, A, b, x, cycle),
            GAMG_EVENTS, flush)
        out[cycle]["seconds_so_far"] = time.perf_counter() - t_start
    from petsc_tpu_torch import native
    out["native_openmp"] = native.openmp
    out["seconds_so_far"] = time.perf_counter() - t_start
    return (out, *res["f64"])


def product_kernel(meta):
    """The kernel that applies an operator of this meta: S1 for the
    constant stencil (build_dnd's folded box), V1 for every other grid
    stencil, S2 for CSR, B1 for BSR."""
    if meta[0] == "aij_csr":
        return "csr_spmv"
    if meta[0] == "aij_bsr":
        return "bsr_spmv"
    if meta[0] == "aij_dnd" and len(meta) > 6 and all(c is not None for c in meta[6]):
        return "const_stencil"
    return "dnd_stencil"


GRID_KERNELS = ("const_stencil", "dnd_stencil", "csr_spmv", "q1_prolong", "q1_restrict",
                "cheby_update", "triad", "axpy_normsq", "dot2")


def grid_launches_needed(its, levels, probes=27, lanczos=10):
    """The launches of one CG + GAMG solve with the structured head, set-up
    included, from the hierarchy's operator and transfer kinds: its + 1 PC
    applications, each with, on every level but the coarsest, 5 products
    with the level's A (A x and A p per smoothing, the residual), 4 C1,
    2 K2, and the transfers (a Q1 P: one Q1P and one Q1R; an aggregation P:
    two S2, P and R = P^T); CG adds one product with level 0's A, two K2,
    one K3 and two K4 per iteration and one K4 before them. Each head level
    (a Q1 P) adds, in the set-up, 27 probes of one Q1P, one product with its
    A and one Q1R, and 10 Lanczos products with its A."""
    need = dict.fromkeys(GRID_KERNELS, 0)
    napply = its + 1
    for lev in levels[:-1]:
        a = product_kernel(lev.A.meta)
        need[a] += 5 * napply
        need["cheby_update"] += 4 * napply
        need["triad"] += 2 * napply
        if lev.P.meta[0] == "interp_q1":
            need["q1_prolong"] += napply + probes
            need["q1_restrict"] += napply + probes
            need[a] += probes + lanczos
        else:
            need["csr_spmv"] += 2 * napply
    need[product_kernel(levels[0].A.meta)] += its
    need["triad"] += 2 * its
    need["axpy_normsq"] += its
    need["dot2"] += 1 + 2 * its
    return need


GAMG_GRID_EVENTS = {k: f"PCGAMGSetUp_{k}" for k in ("head", "tail_download", "native",
                                                   "graph", "coarsen", "prol0", "emax",
                                                   "smooth_prol", "SpGEMM")}
GAMG_GRID_EVENTS.update(lu="PCMGSetUp_LU", pc_setup_total="PCSetUp_gamg")
_AGG_TAIL = ("graph", "coarsen", "prol0", "emax", "smooth_prol", "SpGEMM")


def check_gamg_grid_solve(pk, ksp, b, x, cycle):
    """The reference's 128^3 CG+GAMG grid contract (GAMG_GRID_* constants):
    its, reason, relres, history, rows and kinds of A and P per level, each
    Chebyshev bound, and a true residual no worse than 10x the reference's."""
    import numpy as np
    import torch
    its = ksp.getIterationNumber()
    reason = ksp.getConvergedReason().name
    relres = ksp.getResidualNorm() / ksp._rnorm0
    Ax = pk.const_stencil_plain(x.array, (N_MAIN,) * 3, 26.0, -1.0, True)
    true_rel = float(torch.linalg.vector_norm(b.array - Ax) / torch.linalg.vector_norm(b.array))
    hist, want = ksp.getConvergenceHistory(), np.array(GAMG_GRID_HIST[cycle])
    hist_rel = (float(np.max(np.abs(hist - want) / want)) if hist.shape == want.shape
                else math.inf)
    levels = ksp.getPC()._impl.levels
    hier = {"rows": [lev.A.getSize()[0] for lev in levels],
            "A_kind": [lev.A.meta[0] for lev in levels],
            "P_kind": [lev.P.meta[0] for lev in levels[:-1]],
            "emax": [lev.emax for lev in levels[:-1]]}
    emax_rel = (max(abs(a - b) / b for a, b in zip(hier["emax"], GAMG_GRID_EMAX[cycle]))
                if len(hier["emax"]) == len(GAMG_GRID_EMAX[cycle]) else math.inf)
    want_hier = {"rows": list(GAMG_GRID_ROWS), "A_kind": list(GAMG_GRID_A_KINDS),
                 "P_kind": list(GAMG_GRID_P_KINDS)}
    bad_hier = {k: (hier[k], v) for k, v in want_hier.items() if hier[k] != v}
    if its != GAMG_GRID_ITS or reason != "CONVERGED_RTOL" or not relres <= 1e-8 \
            or not hist_rel <= MG_HIST_TOL[cycle] or bad_hier \
            or not emax_rel <= GAMG_GRID_EMAX_TOL[cycle] \
            or not true_rel <= 10 * GAMG_GRID_TRUE_RELRES[cycle]:
        raise AssertionError(
            f"128^3 CG+GAMG grid ({cycle} cycle): its {its} (want {GAMG_GRID_ITS}), {reason}, "
            f"relres {relres}, history vs the reference {hist_rel} (tol {MG_HIST_TOL[cycle]}), "
            f"hierarchy (got, want) {bad_hier}, emax vs the reference {emax_rel} (tol "
            f"{GAMG_GRID_EMAX_TOL[cycle]}), true relres {true_rel} (the reference's "
            f"{GAMG_GRID_TRUE_RELRES[cycle]})")
    if not bool(torch.isfinite(x.array).all()):
        raise AssertionError("CG+GAMG grid solution has non-finite entries")
    return {"its": its, "reason": reason, "relres": relres, "true_relres": true_rel,
            "reference_true_relres": GAMG_GRID_TRUE_RELRES[cycle],
            "history_rel_diff_vs_reference": hist_rel, "emax_rel_diff_vs_reference": emax_rel,
            "hierarchy": hier}


def grid_solve(pt, pk, sb, cycle):
    """CG + GAMG with the structured head on build_dnd((128,)*3, "box") +
    as_mat through the user's entry points (bench.py's solve), every launch
    count set to 0 just before init and read just after the solve, the
    solve checked and its launches held to grid_launches_needed. Returns
    (ksp, b, x, the record)."""
    import torch
    args = ["-ksp_type", "cg", "-pc_type", "gamg", "-ksp_rtol", "1e-8", "-ksp_max_it", "60"]
    if cycle == "f32":
        args += ["-pc_mg_dtype", "single"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live0 = torch.cuda.memory_allocated()
    reset_launches()
    pt.init(args=args)
    pt.log().reset()
    t0 = time.perf_counter()
    A = sb.as_mat(*sb.build_dnd((N_MAIN,) * 3, kind="box"))
    ksp = pt.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    ksp.setUp()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    b = A.createVecLeft()
    b.set(1.0)
    x = A.createVecRight()
    t1 = time.perf_counter()
    ksp.solve(b, x)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t1
    launches = launch_counts()
    chk = check_gamg_grid_solve(pk, ksp, b, x, cycle)
    levels = ksp.getPC()._impl.levels
    need = grid_launches_needed(chk["its"], levels)
    bad = {k: (launches[k], v) for k, v in need.items() if launches[k] != v}
    if bad:
        raise AssertionError(f"{args}: launches (got, want): {bad}")
    v1 = {str(lev.A.meta[1]): lev.A.op().mult.kernel for lev in levels
          if product_kernel(lev.A.meta) == "dnd_stencil"}
    if set(v1.values()) != {"window"}:
        raise AssertionError(f"{args}: V1's kernel per level: {v1}")
    split = setup_seconds(pt, GAMG_GRID_EVENTS)
    rec = {**chk, "args": args, "setup_s": setup_s, "setup_split_s": split,
           "setup_parts_s": {"head_probes_and_lanczos": split["head"],
                             "tail_download": split["tail_download"],
                             "aggregation_tail": sum(split[k] for k in _AGG_TAIL),
                             "coarse_lu": split["lu"]},
           "first_solve_s": first_s, "launches": launches, "launches_needed": need,
           "v1_kernel_per_level": v1,
           "peak_mem_MiB": torch.cuda.max_memory_allocated() / 2 ** 20,
           "path_peak_mem_MiB": (torch.cuda.max_memory_allocated() - live0) / 2 ** 20}
    return ksp, b, x, rec


def grid_kernel_row(name, dtype, fn, plain, library_fn, nbytes, flops, tol, earlier=None,
                    **extra):
    """One kernel against its plain version on the same inputs (and the
    earlier design's kernel, where given, against it too), each timed
    later after the clean flush by the caller's time_ms; the bound from the
    bytes and flops of the function."""
    import torch
    k, p = fn(), plain()
    torch.cuda.synchronize()
    dn = str(dtype).replace("torch.", "")
    err = rel_err(k, p)
    if not err <= tol:
        raise AssertionError(f"{name} {dn} {extra}: rel err {err} > {tol}")
    if earlier is not None and not rel_err(earlier(), p) <= tol:
        raise AssertionError(f"{name} {dn} {extra}: the earlier design disagrees")
    b_ms, b_by = bound(nbytes, flops, dn)
    return {"name": name, "dtype": dn, "rel_err": err, "tol": tol,
            "equal_bits": bool(torch.equal(k, p)),
            "max_abs_err": float((k.double() - p.double()).abs().max()),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, **extra,
            "_fn": fn, "_plain": plain, "_library": library_fn, "_earlier": earlier}


EARLIER = Path(__file__).resolve().parent / "earlier_kernels"
EARLIER_SOURCES = ("q1_prolong_per_output.cu", "q1_restrict_per_output.cu",
                   "trisolve_grid_barrier.cu", "bsr_spmv_per_output.cu", "agg_block_16rows.cu",
                   "csr_spmm_warp_per_row.cu", "subdomain_warp_per_row.cu",
                   "dst_scatter_thread_per_dst.cu", "swarm_cic_atomic.cu",
                   "swarm_cic_interp_shapes.cu")


def start_earlier_build():
    """Start the build of the earlier designs (earlier_kernels/*.cu, which
    the package's library does not hold) into a git-ignored library of
    their own, one nvcc per source, all started together; returns (the
    [(object, process)] or None when built, the library path, the start
    time)."""
    import hashlib
    from petsc_tpu_torch.ops import cuda_build
    srcs = [EARLIER / s for s in EARLIER_SOURCES]
    h = hashlib.sha256(" ".join(cuda_build.FLAGS).encode())
    for src in srcs:
        h.update(src.read_bytes())
    lib = cuda_build.BUILD / f"earlier-{h.hexdigest()[:16]}" / "libearlier.so"
    if lib.exists():
        return None, lib, time.perf_counter()
    lib.parent.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in srcs:
        obj = lib.parent / f"{src.name}.o"
        cmd = [cuda_build._nvcc(), *cuda_build.FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    return procs, lib, time.perf_counter()


def stop_earlier_build(build):
    """Kill the earlier designs' nvcc processes that still run."""
    for _, p in build[0] or ():
        p.kill()
        p.wait()


def load_earlier(build):
    """The earlier designs' library, once its build has ended (its objects
    linked); raises if it failed. Returns (library, seconds the build took,
    or None)."""
    import ctypes
    from petsc_tpu_torch.ops import cuda_build
    procs, lib, t0 = build
    seconds = None
    if procs is not None:
        for obj, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                stop_earlier_build(build)
                raise AssertionError(f"nvcc of the earlier design {obj.stem} failed:\n{out}")
        tmp = lib.with_suffix(".tmp")
        link = subprocess.run([cuda_build._nvcc(), "-shared", "-o", str(tmp),
                               *[str(o) for o, _ in procs]], capture_output=True, text=True)
        if link.returncode != 0:
            raise AssertionError(f"linking the earlier designs failed:\n{link.stdout}"
                                 f"{link.stderr}")
        tmp.replace(lib)
        seconds = time.perf_counter() - t0
    vp, i32, i64, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
    L = ctypes.CDLL(str(lib))
    for sfx in ("f64", "f32"):
        for name, args in (("cic_deposit", [vp, i64, i32] + [vp] * 4 + [i32, i32, vp, i64]
                            + [f64] * 3 + [i32] * 7 + [vp]),
                           ("cic_interp", [vp, i64, i32, vp, vp, vp] + [f64] * 3 + [i32] * 10
                            + [vp]),
                           ("cic_pairs", [vp, vp, i64, i32, vp])):
            fn = getattr(L, f"ptt_earlier_{name}_{sfx}")
            fn.argtypes = args
            fn.restype = ctypes.c_int
    for name in ("q1_prolong", "q1_restrict"):
        for sfx in ("f64", "f32"):
            fn = getattr(L, f"ptt_earlier_{name}_{sfx}")
            fn.argtypes = [vp, vp] + [i32] * 7 + [vp]
            fn.restype = ctypes.c_int
    for sfx in ("f64", "f32"):
        fn = getattr(L, f"ptt_earlier_trisolve_{sfx}")
        fn.argtypes = [vp, vp, vp, i32, vp, vp, vp, vp, vp, i32, i32, vp, i32, vp]
        fn.restype = ctypes.c_int
        fn = getattr(L, f"ptt_earlier_bsr_spmv_{sfx}")
        fn.argtypes = [vp] * 5 + [ctypes.c_longlong, i32, i32, vp]
        fn.restype = ctypes.c_int
        fn = getattr(L, f"ptt_earlier_agg_block_apply_{sfx}")
        fn.argtypes = [vp] * 7 + [i32, i32, i32, vp]
        fn.restype = ctypes.c_int
        fn = getattr(L, f"ptt_earlier_csr_spmm_{sfx}")
        fn.argtypes = [vp] * 5 + [ctypes.c_longlong, i32, i32, i32, vp]
        fn.restype = ctypes.c_int
        fn = getattr(L, f"ptt_earlier_subdomain_apply_{sfx}")
        fn.argtypes = [i32] + [vp] * 8 + [i32] * 6 + [vp]
        fn.restype = ctypes.c_int
        fn = getattr(L, f"ptt_earlier_dst_scatter_{sfx}")
        fn.argtypes = [vp] * 5 + [ctypes.c_longlong, i32, i32, vp]
        fn.restype = ctypes.c_int
    return L, seconds


def earlier_q1(earlier, name, x, fshape):
    """Q1P (name "q1_prolong", x coarse) or Q1R ("q1_restrict", x fine) by
    the earlier per-output design (earlier_kernels/), on the same stream;
    raises on a CUDA error."""
    import torch
    from petsc_tpu_torch.ops import cuda_build
    f3 = (1,) * (3 - len(fshape)) + tuple(fshape)
    c3 = tuple((s + 1) // 2 for s in f3)
    y = torch.empty(math.prod(f3 if name == "q1_prolong" else c3), dtype=x.dtype,
                    device=x.device)
    fn = getattr(earlier, f"ptt_earlier_{name}_" + ("f64" if x.dtype == torch.float64
                                                    else "f32"))
    cuda_build.check(f"earlier {name}", fn(y.data_ptr(), x.data_ptr(), *f3, *c3,
                                           x.get_device(),
                                           torch.cuda.current_stream().cuda_stream))
    return y


def generic_dnd_stencil(gridk, shape, offs, cvals, coef):
    """x -> A x by V1's generic kernel (the earlier design, one output per
    thread) for a stencil that its plan gives the window kernel; launches
    counted in a scratch dict, not in LAUNCHES."""
    import torch
    from petsc_tpu_torch.ops import cuda_build
    _, n, _, args, arrays = gridk._dnd_plan(shape, offs, cvals)
    scratch = {"dnd_stencil": 0}

    def apply(x):
        y = torch.empty_like(x)
        cuda_build.launch(scratch, "dnd_stencil", x, y.data_ptr(), x.data_ptr(),
                          coef.data_ptr(), *args)
        return y

    apply.taps = arrays
    return apply


def star2_offsets():
    """The 3-D radius-2 star: the centre, then +-1 and +-2 along each axis
    (13 offsets, which V1's window does not take)."""
    offs = [(0, 0, 0)]
    for ax in range(3):
        for d in (-2, -1, 1, 2):
            offs.append(tuple(d if a == ax else 0 for a in range(3)))
    return tuple(offs)


def q1r_plan(gridk, fshape, itemsize, aligned):
    """Q1R's launch plan as its wrapper makes it."""
    return gridk._q1_restrict_plan(tuple(fshape), itemsize, aligned, gridk._Q1R_THREADS)


def phase_grid_kernels(gridk, gd, interp, gamg, ksps, flush, earlier):
    """Each grid kernel against its plain version, f64 and f32 (each
    cycle's own hierarchy), with equal bits required of V1, Q1P and Q1R:
    V1's window kernel on the path's probed 64^3, 32^3 and 16^3 levels (27
    planes) and on an odd 65^3 grid (27 random planes, the scalar variant),
    each timed beside the earlier design (V1's generic kernel, one output
    per thread) in turns, earlier, new, new, earlier; V1's generic kernel
    on the 64^3 level's stencil with its offsets reversed and on a radius-2
    star at 32^3 (random planes); Q1P at 128^3 <- 64^3, 129^3 <- 65^3 and
    64^3 <- 32^3, each timed beside the earlier per-output design
    (earlier_kernels/) in turns; Q1R at the same shapes beside its earlier
    per-output design likewise (at the odd size
    F.interpolate(trilinear, align_corners=True) computes Q1P and F.conv3d
    with stride 2 and the [.5, 1, .5]^3 weights computes Q1R, each timed as
    the library call); Q1R's plan on each Q1 level of the path, which must
    take the 16-byte variant; then the card's probed 32^3 planes (from the
    f64 hierarchy's 64^3 level) against the host Galerkin product of the
    port's SpGEMM (1e-12 relative). Returns (rows, the f32 rows at the
    path's shapes keyed by kernel, the Galerkin check, Q1R's plan per
    level and cycle)."""
    import torch
    import torch.nn.functional as F
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    tol = {torch.float64: 1e-13, torch.float32: 1e-6}
    torch.backends.cudnn.allow_tf32 = False       # F.conv3d in the operands' own precision
    rows, main, q1r_path = [], {}, {}
    no_lib = "none: no single PyTorch call applies per-point coefficient planes"
    for cycle, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        isz = torch.empty((), dtype=dtype).element_size()
        levels = ksps[cycle].getPC()._impl.levels
        lev1 = levels[1].A
        box = lev1.meta[2]
        v1_cases = [(lev.A.meta[1], lev.A.device_data()["coef"], f"probed level {lev.A.meta[1]}")
                    for lev in levels[1:4]]
        v1_cases.append(((65,) * 3, torch.rand((27,) + (65,) * 3, generator=gen, device=dev,
                                               dtype=dtype), "random planes"))
        for shape, coef, what in v1_cases:
            if coef.dtype != dtype:
                raise AssertionError(f"{what} planes are {coef.dtype} in the {cycle} cycle")
            n1 = math.prod(shape)
            cvals = (None,) * len(box)
            x = torch.rand(n1, generator=gen, device=dev, dtype=dtype)
            v1 = gridk.dnd_stencil_fn(shape, box, cvals, coef)   # planned as the binder plans it
            if v1.kernel != "window":
                raise AssertionError(f"V1 on {shape} took the {v1.kernel} kernel")
            old = generic_dnd_stencil(gridk, shape, box, cvals, coef)
            win = v1.window
            cfg = gridk.dnd_window_config(dtype, win["vector"], True, win["block"], dev)
            rows.append(grid_kernel_row(
                "dnd_stencil", dtype, lambda v1=v1, x=x: v1(x),
                lambda x=x, coef=coef, shape=shape, box=box, cvals=cvals:
                    gridk.dnd_stencil_plain(x, shape, box, cvals, coef), None,
                (len(box) + 2) * n1 * isz, 2 * len(box) * n1, tol[dtype],
                earlier=lambda old=old, x=x: old(x), shape=list(shape), planes=len(box),
                coef=what, kernel="window", variant="vector" if win["vector"] else "scalar",
                block=list(win["block"]), chunk=win["chunk"], grid=list(win["grid"]),
                launch=cfg, library=no_lib))
        # the generic kernel: the 64^3 stencil in reverse order, a radius-2 star
        coef1 = lev1.device_data()["coef"]
        shape1 = lev1.meta[1]
        for shape, offs, coef, what in (
                (shape1, box[::-1], coef1.flip(0).contiguous(), "probed level, reversed"),
                ((32,) * 3, star2_offsets(),
                 torch.rand((13,) + (32,) * 3, generator=gen, device=dev, dtype=dtype),
                 "random planes, radius-2 star")):
            n1 = math.prod(shape)
            cvals = (None,) * len(offs)
            x = torch.rand(n1, generator=gen, device=dev, dtype=dtype)
            v1 = gridk.dnd_stencil_fn(shape, offs, cvals, coef)
            if v1.kernel != "generic":
                raise AssertionError(f"V1 on {what} took the {v1.kernel} kernel")
            rows.append(grid_kernel_row(
                "dnd_stencil", dtype, lambda v1=v1, x=x: v1(x),
                lambda x=x, coef=coef, shape=shape, offs=offs, cvals=cvals:
                    gridk.dnd_stencil_plain(x, shape, offs, cvals, coef), None,
                (len(offs) + 2) * n1 * isz, 2 * len(offs) * n1, tol[dtype],
                shape=list(shape), planes=len(offs), coef=what, kernel="generic",
                library=no_lib))
        for fshape in ((N_MAIN,) * 3, (N_MAIN + 1,) * 3, (N_MAIN // 2,) * 3):
            cshape = tuple((s + 1) // 2 for s in fshape)
            nf, nc = math.prod(fshape), math.prod(cshape)
            xc = torch.rand(nc, generator=gen, device=dev, dtype=dtype)
            xf = torch.rand(nf, generator=gen, device=dev, dtype=dtype)
            lib = lib_r = None
            if fshape[0] % 2:
                xc5, xf5 = xc.reshape((1, 1) + cshape), xf.reshape((1, 1) + fshape)
                lib = lambda xc5=xc5, fshape=fshape: F.interpolate(  # noqa: E731
                    xc5, size=fshape, mode="trilinear", align_corners=True).reshape(-1)
                if not rel_err(lib(), gridk.q1_prolong_plain(xc, fshape)) <= 1e-6:
                    raise AssertionError("F.interpolate does not compute Q1P at odd sizes")
                # per axis c[j] = .5 f[2j-1] + f[2j] + .5 f[2j+1], zeros outside
                h = torch.tensor([0.5, 1.0, 0.5], dtype=dtype, device=dev)
                w = (h[:, None, None] * h[None, :, None] * h[None, None, :]).reshape(1, 1, 3, 3, 3)
                lib_r = lambda xf5=xf5, w=w: F.conv3d(  # noqa: E731
                    xf5, w, stride=2, padding=1).reshape(-1)
                if not rel_err(lib_r(), gridk.q1_restrict_plain(xf, fshape)) <= 1e-6:
                    raise AssertionError("F.conv3d does not compute Q1R at odd sizes")
            rows.append(grid_kernel_row(
                "q1_prolong", dtype, lambda xc=xc, fshape=fshape: gridk.q1_prolong(xc, fshape),
                lambda xc=xc, fshape=fshape: gridk.q1_prolong_plain(xc, fshape), lib,
                (nf + nc) * isz, 2 * nf, tol[dtype],
                earlier=lambda xc=xc, fshape=fshape: earlier_q1(earlier, "q1_prolong", xc, fshape),
                fine=list(fshape), pair_stores=gridk._q1_prolong_plan(fshape)[2],
                library="F.interpolate(trilinear, align_corners=True)" if lib else
                "none at an even size: F.interpolate has no clamp of the last odd point"))
            plan = q1r_plan(gridk, fshape, isz, xf.data_ptr() % 16 == 0)
            rows.append(grid_kernel_row(
                "q1_restrict", dtype,
                lambda xf=xf, fshape=fshape: gridk.q1_restrict(xf, fshape),
                lambda xf=xf, fshape=fshape: gridk.q1_restrict_plain(xf, fshape), lib_r,
                (nf + nc) * isz, 2 * nf, tol[dtype], fine=list(fshape),
                earlier=lambda xf=xf, fshape=fshape: earlier_q1(earlier, "q1_restrict", xf, fshape),
                variant="vector" if plan["vector"] else "scalar", block=list(plan["block"]),
                grid=list(plan["grid"]),
                library="F.conv3d(stride 2, padding 1, [.5, 1, .5]^3)" if lib_r else
                "none at an even size: F.conv3d has no clamp of the last odd point"))
        # Q1R's variant at each of the path's levels (fresh, aligned vectors)
        q1r_plans = {str(lev.A.meta[1]): q1r_plan(gridk, lev.A.meta[1], isz, True)
                     for lev in levels[:-1] if lev.P.meta[0] == "interp_q1"}
        if len(q1r_plans) != 4 or not all(p["vector"] for p in q1r_plans.values()):
            raise AssertionError(f"Q1R's plan on the path's levels ({cycle}): {q1r_plans}")
        q1r_path[cycle] = {k: {"vector": p["vector"], "block": list(p["block"]),
                               "grid": list(p["grid"])} for k, p in q1r_plans.items()}
    unequal = [(r["name"], r["dtype"], r.get("shape") or r.get("fine")) for r in rows
               if r["name"] in ("dnd_stencil", "q1_prolong", "q1_restrict")
               and not r["equal_bits"]]
    if unequal:
        raise AssertionError(f"kernels that differ from their plain versions in bits: {unequal}")
    for r in rows:
        fn, plain, lib, old = r.pop("_fn"), r.pop("_plain"), r.pop("_library"), r.pop("_earlier")
        if old is None:
            r["ms"] = time_ms(fn, flush)
        else:   # in turns: earlier, new, new, earlier
            turns = [time_ms(old, flush), time_ms(fn, flush), time_ms(fn, flush),
                     time_ms(old, flush)]
            r["turns_ms"] = turns
            r["ms"] = (turns[1] + turns[2]) / 2
            r["earlier_ms"] = (turns[0] + turns[3]) / 2
            r["earlier_share_of_bound"] = r["bound_ms"] / r["earlier_ms"]
        r["plain_ms"] = time_ms(plain, flush)
        r["library_ms"] = time_ms(lib, flush) if lib is not None else None
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        path_shape = [N_MAIN // 2] * 3 if r["name"] == "dnd_stencil" else [N_MAIN] * 3
        if r["dtype"] == "float32" and (r.get("shape") or r.get("fine")) == path_shape \
                and r.get("kernel") != "generic" and r["name"] not in main:
            main[r["name"]] = r
    # the probed planes against the host Galerkin product, 64^3 -> 32^3 in f64
    levels = ksps["f64"].getPC()._impl.levels
    A1, A2 = levels[1].A, levels[2].A
    t0 = time.perf_counter()
    A1_sp = gd.dnd_to_csr(A1.meta, A1.device_data())
    P = interp.MatInterpQ1(A1.meta[1], A2.meta[1]).to_scipy()
    host = gamg._galerkin(A1_sp, P)
    card = gd.dnd_to_csr(A2.meta, A2.device_data())
    diff = abs(card - host).max() / abs(host).max()
    if not diff <= 1e-12:
        raise AssertionError(f"probed 32^3 planes vs the host Galerkin product: {diff}")
    galerkin = {"fine": list(A1.meta[1]), "coarse": list(A2.meta[1]), "nnz": int(host.nnz),
                "rel_diff": float(diff), "host_seconds": time.perf_counter() - t0}
    torch.cuda.empty_cache()
    return rows, main, galerkin, q1r_path


def phase_gamg_grid(pt, pk, gridk, sb, smi, t_start, flush, jac_ms, earlier):
    """CG + GAMG with the structured head on the 128^3 box27 stencil
    operator (bench.py's solve), f32 cycle (bench's -pc_mg_dtype single) and
    f64 cycle, each checked against the reference's run, timed warm (best of
    3) and held to its launches. Returns (the record, the f64 KSP, b, x, its
    warm ms, its launches, the two KSPs)."""
    from petsc_tpu_torch.dm import interp
    from petsc_tpu_torch.pc import gamg, gamg_device as gd
    out = {"phase": "gamg_grid", "n": N_MAIN, "stencil": "box27",
           "operator": "build_dnd + as_mat (bench.py's solve)", "rtol": 1e-8, "max_it": 60,
           "head": "structured, device (Q1, probed Galerkin, Lanczos)",
           "tail": "smoothed aggregation (MIS-2 + square fix, then MIS)",
           "smoother": "chebyshev(2,2)/jacobi", "coarse": "dense LU", "nvidia_smi": smi}
    res, ksps = {}, {}
    for cycle in ("f32", "f64"):
        ksp, b, x, rec = grid_solve(pt, pk, sb, cycle)
        rec["warm_ms_best_of_3"] = warm_ms(ksp, b, x)
        check_gamg_grid_solve(pk, ksp, b, x, cycle)
        rec["ms_per_it"] = rec["warm_ms_best_of_3"] / rec["its"]
        rec["cg_jacobi_ratio"] = jac_ms / rec["warm_ms_best_of_3"]
        rec["seconds_so_far"] = time.perf_counter() - t_start
        out[cycle] = rec
        res[cycle] = (ksp, b, x, rec["warm_ms_best_of_3"], rec["launches"])
        ksps[cycle] = ksp
    out["cg_jacobi_warm_ms"] = jac_ms
    rows, main, galerkin, q1r_path = phase_grid_kernels(gridk, gd, interp, gamg, ksps, flush,
                                                        earlier)
    out["kernel_checks"] = rows
    out["q1_restrict_plan_per_level"] = q1r_path
    out["probed_vs_host_galerkin"] = galerkin
    out["seconds_so_far"] = time.perf_counter() - t_start
    return out, main, res


def phase_cheby(pk, flush):
    """C1 in both modes against its plain version on the same inputs (f64
    1e-12, f32 1e-5 relative on each of r, p and x) at n = 128^3 and
    2^24 + 37, each timed after the clean flush beside the plain version.
    No single PyTorch call computes C1 (library_ms None). Returns (rows,
    the f64 step row at 128^3)."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(77)
    rows, main = [], None
    for dtype in (torch.float64, torch.float32):
        dn = str(dtype).replace("torch.", "")
        isz = torch.empty((), dtype=dtype).element_size()
        for n in (N_MAIN ** 3, (1 << 24) + 37):
            b, w, dinv, r0, p0, x0 = (torch.rand(n, generator=gen, device=dev, dtype=dtype)
                                      for _ in range(6))
            for mode in ("first", "step"):
                kw = {"b": b} if mode == "first" else {"a": 0.6}
                k, p = [t.clone() for t in (r0, p0, x0)], [t.clone() for t in (r0, p0, x0)]
                pk.cheby_update(mode, *k, w, dinv, 0.3, 0.9, **kw)
                pk.cheby_update_plain(mode, *p, w, dinv, 0.3, 0.9, **kw)
                torch.cuda.synchronize()
                err = max(rel_err(a, c) for a, c in zip(k, p))
                if not err <= TOL[dn]:
                    raise AssertionError(f"cheby_update {mode} {dn} n={n}: rel err {err}")
                max_abs = max(float((a - c).abs().max()) for a, c in zip(k, p))
                nbytes = (7 if mode == "first" else 8) * n * isz
                b_ms, b_by = bound(nbytes, (4 if mode == "first" else 6) * n, dn)
                row = {"name": "cheby_update", "mode": mode, "dtype": dn, "n": n,
                       "rel_err": err, "tol": TOL[dn], "max_abs_err": max_abs,
                       "ms": time_ms(lambda: pk.cheby_update(mode, *k, w, dinv, 0.3, 0.9, **kw),
                                     flush),
                       "plain_ms": time_ms(
                           lambda: pk.cheby_update_plain(mode, *p, w, dinv, 0.3, 0.9, **kw),
                           flush),
                       "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
                row["share_of_bound"] = b_ms / row["ms"]
                rows.append(row)
                if (dn, n, mode) == ("float64", N_MAIN ** 3, "step"):
                    main = row
            del b, w, dinv, r0, p0, x0, k, p
    torch.cuda.empty_cache()
    return rows, main


def config2_solve(pt, shape, extra=()):
    """BASELINE config 2 through the user's entry points: init with rtol
    1e-8 and max_it 400 (and `extra`), the stencil7 operator on `shape` as
    a MatAIJ from COO triplets (setPreallocationCOO, setValuesCOO: K8 on
    the card), a KSP with setFromOptions and no type set, b = A cos(0.01 i)
    (the product taken on the host from the triplets, as bench_spmv.py
    takes it), x0 = 0. Returns (ksp, A, b, x, the host CSR, cos(0.01 i))."""
    import numpy as np
    import scipy.sparse as sp
    from petsc_tpu_torch.ops.stencil_build import stencil7_coo
    pt.init(args=["-ksp_rtol", "1e-8", "-ksp_max_it", "400", *extra])
    i, j, v = stencil7_coo(*shape)
    n = int(np.prod(shape))
    A = pt.MatAIJ()
    A.setSizes(n)
    A.setPreallocationCOO(i, j)
    A.setValuesCOO(v)
    A_sp = sp.csr_matrix((v, (i, j)), shape=(n, n))
    xs = np.cos(0.01 * np.arange(n))
    ksp = pt.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    b = pt.Vec.from_array(A_sp @ xs)
    x = A.createVecRight()
    ksp.solve(b, x)
    return ksp, A, b, x, A_sp, xs


def check_config2(ksp, b, x, A_sp, xs, its, reason, hist, true_relres, max_err,
                  hist_tol=GMRES_HIST_TOL):
    """The solve against the reference's: its, reason, the residual history
    (hist_tol relative), a true relative residual and an error no worse than
    10x the reference's, finite values of the right shape."""
    import numpy as np
    import torch
    xh = x.array.double().cpu().numpy()
    bh = b.array.double().cpu().numpy()
    if xh.shape != xs.shape or not bool(torch.isfinite(x.array).all()):
        raise AssertionError(f"config 2: solution of shape {xh.shape} or not finite")
    got = {"its": ksp.getIterationNumber(), "reason": ksp.getConvergedReason().name,
           "ksp_type": ksp.getType(), "pc_type": ksp.getPC().getType(),
           "rnorm": ksp.getResidualNorm(),
           "true_relres": float(np.linalg.norm(bh - A_sp @ xh) / np.linalg.norm(bh)),
           "max_err": float(np.abs(xh - xs).max())}
    h = ksp.getConvergenceHistory()
    got["history_rel_err"] = (float(np.max(np.abs(h - np.asarray(hist)) / np.asarray(hist)))
                              if len(hist) and len(h) == len(hist) else 0.0)
    if got["its"] != its or got["reason"] != reason or len(h) != len(hist) \
            or not got["history_rel_err"] <= hist_tol \
            or not got["true_relres"] <= 10 * true_relres or not got["max_err"] <= 10 * max_err:
        raise AssertionError(f"config 2 against the reference: got {got}, want its {its}, "
                             f"{reason}, history to {hist_tol}, true relres <= 10 x "
                             f"{true_relres}, error <= 10 x {max_err}")
    return got


def trisolve_operands(sw):
    """The triangle of a sweep as a CSR on its device, rows in row order,
    with the diagonal that makes it a triangular solve: 1/scale (or 1) on
    the diagonal and the factor off it, so that the solve equals the sweep;
    for torch.triangular_solve, the library's sparse triangular solve."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    rows = sw.rows.cpu().numpy()
    rl = np.diff(sw.rp.cpu().numpy())
    r = np.repeat(rows, rl)
    c = sw.cols.cpu().numpy()
    vals = sw.vals.double().cpu().numpy()
    d = np.ones(sw.m) if sw.scale is None else np.empty(sw.m)
    if sw.scale is not None:
        d[rows] = 1.0 / sw.scale.double().cpu().numpy()
    M = (sp.csr_matrix((vals, (r, c)), shape=(sw.m, sw.m)) + sp.diags(d)).tocsr()
    M.sort_indices()
    dev = sw.rows.device
    return torch.sparse_csr_tensor(torch.as_tensor(M.indptr, dtype=torch.int64, device=dev),
                                   torch.as_tensor(M.indices, dtype=torch.int64, device=dev),
                                   torch.as_tensor(M.data, device=dev), size=M.shape)


def wide_sweep(width, device, tail=1000, hop=64, seed=12):
    """A strictly lower sweep whose first level holds `width` rows without
    entries; then `tail` rows, each reading two rows of the first level and
    the row `hop` before it (when that is past the first level), so that
    hop rows form each later level; scaled by a ramp."""
    import numpy as np
    from petsc_tpu_torch.ops import trisolve as ts
    i = np.arange(width, width + tail)
    cols = [np.sort(np.unique(c)) for c in zip((7 * i) % width, (13 * i + 5) % width)]
    cols = [np.concatenate([c, [r - hop]]) if r - hop >= width else c
            for c, r in zip(cols, i)]
    indptr = np.concatenate([np.zeros(width + 1, dtype=np.int64),
                             np.cumsum([len(c) for c in cols])])
    indices = np.concatenate(cols)
    vals = np.random.default_rng(seed).uniform(-0.4, 0.4, len(indices))
    m = width + tail
    return ts.make_sweep(indptr, indices, vals, lower=True, scale=np.linspace(0.5, 2.0, m),
                         device=device)


def empty_sweep(ts, sw):
    """The sweep `sw` with every entry removed: the same levels, rows and
    scale, no factor (x = b times the scale). Timed, it is the barrier and
    the row loads of each level alone."""
    import numpy as np
    rows = sw.rows.cpu().numpy()
    lev = np.empty(sw.m, dtype=np.int64)
    lev[rows] = np.repeat(np.arange(sw.nlev), np.diff(sw.levels))
    scale = None
    if sw.scale is not None:
        scale = np.empty(sw.m)
        scale[rows] = sw.scale.double().cpu().numpy()
    return ts.sweep_from_levels(lev, np.zeros(sw.m + 1, dtype=np.int64),
                                np.zeros(0, dtype=np.int64), np.zeros(0), scale,
                                dtype=sw.vals.dtype, device=sw.rows.device)


def earlier_trisolve(earlier, sw, b, bar):
    """One sweep of `sw` on b by T1's earlier grid-barrier design
    (earlier_kernels/trisolve_grid_barrier.cu) on the current stream, with
    its own barrier scratch `bar` (two int32 zeros); raises on a CUDA
    error. Not counted in LAUNCHES."""
    import torch
    from petsc_tpu_torch.ops import cuda_build
    x = torch.empty_like(b)
    fn = getattr(earlier, "ptt_earlier_trisolve_" + ("f64" if b.dtype == torch.float64
                                                       else "f32"))
    scale = 0 if sw.scale is None else sw.scale.data_ptr()
    cuda_build.check("earlier trisolve", fn(
        x.data_ptr(), b.data_ptr(), sw.lev_ptr.data_ptr(), sw.nlev, sw.rows.data_ptr(),
        sw.rp.data_ptr(), sw.cols.data_ptr(), sw.vals.data_ptr(), scale,
        int(sw.vals.dtype == torch.float64), sw.width, bar.data_ptr(), b.get_device(),
        torch.cuda.current_stream().cuda_stream))
    return x


def trisolve_variants(ts, sw, earlier):
    """{name: fn(b) -> x} of T1's designs on `sw`: "new" (the plan's
    variant, as the path launches it, counted), "grid" (the grid variant,
    the loads ahead without the cluster barrier) and "earlier" (the
    earlier grid-barrier kernel, earlier_kernels/); the last two counted in a
    scratch dict, not in LAUNCHES."""
    import torch
    grid_plan = ts.sweep_plan(sw, max_blocks=0)
    scratch = {"trisolve": 0}
    bar = torch.zeros(2, dtype=torch.int32, device=sw.rows.device)

    def grid(b):
        x = torch.empty_like(b)
        ts._launch(scratch, sw, b, x, grid_plan)
        return x

    fns = {"new": lambda b: ts.trisolve_sweep(sw, b), "grid": grid}
    if earlier is not None:
        fns["earlier"] = lambda b: earlier_trisolve(earlier, sw, b, bar)
    return fns


def trisolve_row(ts, sw, name, dtype, flush, library=True, plain_reps=3, earlier=None):
    """T1 on one sweep against its plain version on the same b (values unique
    per entry), bit for bit; both timed after the clean flush (the plain
    version, a Python loop over levels, best of `plain_reps`), and, where it
    takes the operand, torch.triangular_solve on the sweep's triangle as a
    sparse CSR (cuSPARSE), checked against T1 to 1e-10 first. The grid
    variant and, with `earlier` (the earlier designs' library), the earlier
    grid-barrier kernel are held to the plain version bit for bit too; with
    `earlier` the three are timed in turns, earlier, grid, new, new, grid,
    earlier (ms is the mean of the new design's two). The bound counts every byte
    of the factor, its indices and level pointer, b and x once, and 2
    flops per entry plus the row's subtraction (and scale)."""
    import torch
    dn = str(dtype).replace("torch.", "")
    gen = torch.Generator(device="cuda").manual_seed(11)
    b = (torch.rand(sw.m, generator=gen, device="cuda", dtype=torch.float64) + 0.5).to(dtype)
    ts.reset_launches()
    k = ts.trisolve_sweep(sw, b)
    torch.cuda.synchronize()
    if ts.LAUNCHES["trisolve"] != 1:
        raise AssertionError(f"T1 {name}: {ts.LAUNCHES['trisolve']} launches for one sweep")
    p = ts.trisolve_sweep_plain(sw, b)
    torch.cuda.synchronize()
    if not torch.equal(k, p):
        raise AssertionError(f"T1 {name} {dn}: differs from its plain version by "
                             f"{rel_err(k, p)} (equal bits required)")
    fns = trisolve_variants(ts, sw, earlier)
    for vname, fn in fns.items():
        if not bool(torch.equal(fn(b), p)):
            raise AssertionError(f"T1 {name} {dn}: the {vname} design gave other bits")
    isz, fsz = b.element_size(), sw.vals.element_size()
    nbytes = (sw.nnz * (fsz + 4) + (sw.m + 1) * 4 + sw.m * 4 + (sw.nlev + 1) * 4
              + (sw.m * fsz if sw.scale is not None else 0) + 2 * sw.m * isz)
    flops = 2 * sw.nnz + sw.m * (2 if sw.scale is not None else 1)
    b_ms, b_by = bound(nbytes, flops, "float64" if sw.vals.dtype == torch.float64 else dn)
    per_level = 1e3 / max(sw.nlev, 1)
    row = {"name": "trisolve", "sweep": name, "dtype": dn,
           "factor_dtype": str(sw.vals.dtype).replace("torch.", ""), "rows": sw.m,
           "entries": sw.nnz, "levels": sw.nlev, "widest_level": sw.width,
           "equal_bits": True, "max_abs_err": 0.0}
    if earlier is not None:
        order = ("earlier", "grid", "new", "new", "grid", "earlier")
        turns = [(v, time_ms(lambda f=fns[v]: f(b), flush)) for v in order]
        mean = {v: statistics.mean(t for u, t in turns if u == v) for v in set(order)}
        row.update(ms=mean["new"], grid_ms=mean["grid"], earlier_ms=mean["earlier"],
                   turns_ms=turns, grid_us_per_level=mean["grid"] * per_level,
                   earlier_us_per_level=mean["earlier"] * per_level,
                   grid_launch=ts.launch_config(sw, dtype, "cuda",
                                                ts.sweep_plan(sw, max_blocks=0)))
    else:
        row["ms"] = time_ms(lambda: fns["new"](b), flush)
    plain_ms = min(time_ms(lambda: ts.trisolve_sweep_plain(sw, b), flush, reps=1)
                   for _ in range(plain_reps))
    lib_ms, lib_note = None, None
    if library:
        try:
            M = trisolve_operands(sw).to(b.dtype)
            lower = name.split()[0] in ("L", "Ut")
            sol = torch.triangular_solve(b[:, None], M, upper=not lower).solution[:, 0]
            torch.cuda.synchronize()
            lib_err = rel_err(sol, k)
            if not lib_err <= (1e-10 if dtype == torch.float64 else 1e-4):
                raise AssertionError(f"differs from T1 by {lib_err}")
            lib_ms = time_ms(lambda: torch.triangular_solve(b[:, None], M, upper=not lower),
                             flush)
            lib_note = (f"torch.triangular_solve(b, A sparse CSR {'lower' if lower else 'upper'}) "
                        f"(cuSPARSE; its analysis runs in every call), rel err to T1 {lib_err}")
        except Exception as e:          # the library call is a yardstick, not the port
            lib_note = f"none: torch.triangular_solve on a sparse CSR operand failed: {e!r}"[:300]
    ms = row["ms"]
    row.update(us_per_level=ms * per_level, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               bytes=nbytes, share_of_bound=b_ms / ms, library_ms=lib_ms, library=lib_note,
               launch=ts.launch_config(sw, dtype, "cuda"))
    return row


def empty_sweep_row(ts, sw, name, flush, earlier):
    """The sweep `sw` with every entry removed (empty_sweep): each design
    equal to the plain version (b times the scale) bit for bit and timed in
    turns, earlier, grid, new, new, grid, earlier, in f64; what is left of
    a level is its barrier and its row loads."""
    import torch
    e = empty_sweep(ts, sw)
    b = torch.rand(e.m, generator=torch.Generator(device="cuda").manual_seed(13), device="cuda",
                   dtype=torch.float64) + 0.5
    p = ts.trisolve_sweep_plain(e, b)
    fns = trisolve_variants(ts, e, earlier)
    for vname, fn in fns.items():
        if not bool(torch.equal(fn(b), p)):
            raise AssertionError(f"T1 {name} without entries: the {vname} design gave other bits")
    order = ("earlier", "grid", "new", "new", "grid", "earlier")
    turns = [(v, time_ms(lambda f=fns[v]: f(b), flush)) for v in order]
    per_level = 1e3 / max(e.nlev, 1)
    mean = {v: statistics.mean(t for u, t in turns if u == v) for v in set(order)}
    return {"sweep": f"{name} without entries", "dtype": "float64", "levels": e.nlev,
            "widest_level": e.width, "variant": ts.sweep_plan(e).variant,
            "ms": mean["new"], "grid_ms": mean["grid"], "earlier_ms": mean["earlier"],
            "turns_ms": turns, **{f"{v}_us_per_level": mean[v] * per_level for v in mean}}


def cluster_shapes(ts, sw, dtype, flush, max_blocks):
    """The new design's ms on `sw` with its widest level spread over at
    most each of `max_blocks` blocks (the plan takes the first), in turns
    (each shape, then the same in reverse), each equal to the plain version
    bit for bit; keyed by "blocks x threads"."""
    import torch
    b = torch.rand(sw.m, generator=torch.Generator(device="cuda").manual_seed(14),
                   device="cuda", dtype=torch.float64).to(dtype) + 0.5
    p = ts.trisolve_sweep_plain(sw, b)
    scratch = {"trisolve": 0}
    out = {}
    for mb in (*max_blocks, *max_blocks[::-1]):
        plan = ts.sweep_plan(sw, max_blocks=mb)

        def fn(plan=plan):
            x = torch.empty_like(b)
            ts._launch(scratch, sw, b, x, plan)
            return x
        if not bool(torch.equal(fn(), p)):
            raise AssertionError(f"T1 cluster of {plan.blocks} x {plan.threads}: other bits")
        out.setdefault(f"{plan.blocks}x{plan.threads}", []).append(time_ms(fn, flush))
    return {k: statistics.mean(v) for k, v in out.items()}


def phase_trisolve(pt, ksp, flush, earlier):
    """T1 at the path's shape (the ILU(0) factors of config 2: both sweeps,
    f64 and f32 vectors on the float64 factors, each in the cluster
    variant, timed in turns beside the grid variant and the earlier design),
    the same sweeps with every entry removed (f64), the cluster's shape on
    the forward sweep, and at odd small shapes (the ILU(1) factors of a
    5 x 13 x 17 stencil7, a float32 factor as SOR's under -real_dtype f32,
    a one-level diagonal triangle wider than a cluster, which takes the
    grid variant), each against its plain version bit for bit. Returns
    (rows, the main row: the forward sweep in f64, the entries-removed
    rows, the cluster shapes)."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    from petsc_tpu_torch.mat import factor
    from petsc_tpu_torch.ops import trisolve as ts
    from petsc_tpu_torch.ops.stencil_build import stencil7_coo
    data = ksp.getPC().device_data()
    for key in ("L", "U"):
        if ts.sweep_plan(data[key]).variant != "cluster":
            raise AssertionError(f"config 2's {key} sweep does not take the cluster variant")
    rows = [trisolve_row(ts, data[key], key, dt, flush, library=True, earlier=earlier)
            for key in ("L", "U") for dt in (torch.float64, torch.float32)]
    empty = [empty_sweep_row(ts, data[key], key, flush, earlier) for key in ("L", "U")]
    shape = (5, 13, 17)
    i, j, v = stencil7_coo(*shape)
    n = int(np.prod(shape))
    A = sp.csr_matrix((v, (i, j)), shape=(n, n))
    L, U, dinv = factor.iluk(A.indptr, A.indices, A.data, 1)
    _, small = ts.make_trisolve_plan(L, U, dinv)
    small.update(ts.make_transpose_tables(L, U, dinv))
    shapes = {"config 2 L": cluster_shapes(ts, data["L"], torch.float64, flush, (16, 11)),
              f"L ILU(1) {shape}": cluster_shapes(ts, small["L"], torch.float64, flush,
                                                  (16, 1))}
    for key in ("L", "U", "Ut", "Lt"):
        for dt in (torch.float64, torch.float32):
            rows.append(trisolve_row(ts, small[key], f"{key} ILU(1) {shape}", dt, flush,
                                     library=False, plain_reps=1))
    s32 = ts.make_sweep(*L, lower=True, dtype=torch.float32)
    rows.append(trisolve_row(ts, s32, "L float32 factor", torch.float32, flush, library=False,
                             plain_reps=1))
    m = 300_001
    diag = ts.make_sweep(np.zeros(m + 1, dtype=np.int64), np.zeros(0, dtype=np.int64),
                         np.zeros(0), lower=True, scale=np.linspace(0.5, 2.0, m))
    if ts.sweep_plan(diag).variant != "grid":
        raise AssertionError("the 300,001-row diagonal does not take the grid variant")
    rows.append(trisolve_row(ts, diag, "diagonal, one level", torch.float64, flush,
                             library=False, plain_reps=1))
    return rows, rows[0], empty, shapes


def config2_launches_needed(its):
    """The launches of config 2's init, assembly and solve: K1 once in
    init, K8 twice in setValuesCOO (v[perm], the diagonal), one S2 and one
    K3 per iteration, and two T1 sweeps per PC application (its + 1: B b,
    then one per iteration); nothing else of the port's kernels."""
    return {"probe": 1, "gather": 2, "axpy_normsq": its, "trisolve": 2 * (its + 1),
            "csr_spmv": its}


def phase_gmres_ilu(pt, smi, t_start, flush, earlier):
    """BASELINE config 2 with PETSc's defaults on the card (see config2_solve),
    every launch count set to 0 just before init and read just after the
    solve; then warm solves, T1's checks and times, and the small variants.
    Returns (the record, (ksp, b, x, the host CSR, the exact solution), warm
    ms, launches, T1's rows and main row)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live0 = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    ksp, A, b, x, A_sp, xs = config2_solve(pt, CONFIG2)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = launch_counts()
    if A.getSize()[0] != CONFIG2_ROWS or A.nnz() != CONFIG2_NNZ or A.meta[0] != "aij_csr":
        raise AssertionError(f"config 2: {A.getSize()[0]} rows, {A.nnz()} entries, "
                             f"kind {A.meta[0]}")
    if ksp.getType() != "gmres" or ksp.getPC().getType() != "ilu" \
            or ksp.getPC()._impl.levels != 0:
        raise AssertionError(f"config 2's defaults: KSP {ksp.getType()}, PC "
                             f"{ksp.getPC().getType()}")
    got = check_config2(ksp, b, x, A_sp, xs, GMRES_ITS, "CONVERGED_RTOL", GMRES_HIST,
                        GMRES_TRUE_RELRES, GMRES_MAX_ERR)
    its = got["its"]
    need = config2_launches_needed(its)
    wrong = {k: (launches[k], v) for k, v in need.items()
             if (launches[k] < v if k == "csr_spmv" else launches[k] != v)}
    others = {k: n for k, n in launches.items() if k not in need and n}
    if wrong or others:
        raise AssertionError(f"config 2's launches (got, need): {wrong}; others {others}")
    peak = (torch.cuda.max_memory_allocated() - live0) / 2 ** 20
    data = ksp.getPC().device_data()
    rec = {"phase": "gmres_ilu", "grid": CONFIG2, "rows": CONFIG2_ROWS, "nnz": CONFIG2_NNZ,
           "operator": "stencil7 (atmosmodd-class, jittered), MatAIJ from COO",
           "options": "-ksp_rtol 1e-8 -ksp_max_it 400, types left to their defaults",
           "nvidia_smi": smi, **got, "launches": launches, "launches_needed": need,
           "first_assembly_setup_and_solve_s": first_s, "path_peak_mem_MiB": peak,
           "levels": {k: data[k].nlev for k in ("L", "U")},
           "widest_level": {k: data[k].width for k in ("L", "U")},
           "pc_setup_s": setup_seconds(pt, {"ilu": "PCSetUp_ilu"})["ilu"]}
    warm = warm_ms(ksp, b, x)
    check_config2(ksp, b, x, A_sp, xs, GMRES_ITS, "CONVERGED_RTOL", GMRES_HIST,
                  GMRES_TRUE_RELRES, GMRES_MAX_ERR)
    rec.update(warm_ms_best_of_3=warm, ms_per_it=warm / its,
               seconds_so_far=time.perf_counter() - t_start)
    t_rows, t_main, t_empty, t_shapes = phase_trisolve(pt, ksp, flush, earlier)
    rec.update(trisolve_checks=t_rows, trisolve_without_entries=t_empty,
               trisolve_cluster_shapes_ms=t_shapes)
    small = {}
    for name, (opts, s_its, s_reason, s_hist, s_rel, s_err) in GMRES_SMALL.items():
        k2, _, b2, x2, A2, xs2 = config2_solve(pt, CONFIG2_SMALL, opts)
        small[name] = {"options": " ".join(opts),
                       **check_config2(k2, b2, x2, A2, xs2, s_its, s_reason, s_hist, s_rel,
                                       s_err)}
    rec["small"] = {"grid": CONFIG2_SMALL, "solves": small}
    rec["seconds_so_far"] = time.perf_counter() - t_start
    return rec, (ksp, b, x, A_sp, xs), warm, launches, t_rows, t_main


# SHA-256 of jax.random.uniform(PRNGKey(0), (128**3,), dtype), the JAX package's
# Vec.setRandom at 128^3 (jax 0.9.0 on the CPU, x64), float64 and float32
SET_RANDOM_SHA256 = {
    "float64": "f570aaf9b21d04b43bcff83098df2be960b3176a66b45299a3b1666364903809",
    "float32": "dcf7fb6a9361280f9d15f7fcb8b87175738c42c3a9f46f8dbc56432fa4f2088a"}
SURFACE_ELEM_RTOL = 1e-15      # elementwise: equal, or within 1e-15 where two roundings meet
SURFACE_RED_RTOL = 1e-12       # reductions (the card sums in another order)
SPIN_EVENT_CYCLES = 20_000_000  # about 10 ms of the card's clock


def surface_vec_checks(pt):
    """Each Vec method of the surface on 128^3 (2,097,152-entry) vectors on
    the card against numpy float64 on the host: elementwise results to
    SURFACE_ELEM_RTOL, reductions to SURFACE_RED_RTOL, setRandom's bits
    against the JAX package's draw (SET_RANDOM_SHA256). Returns the rows."""
    import hashlib
    import numpy as np
    n = N_MAIN ** 3
    rng = np.random.default_rng(21)
    xs, ys, zs = rng.standard_normal(n), rng.standard_normal(n), rng.standard_normal(n)
    xs[::17] = 0.0
    ys[::23] = 0.0
    idx = rng.integers(0, n, 4096)              # repeats: ADD accumulates them
    sub_idx = rng.permutation(n)[:100_000]
    rows = []

    def vecs():
        return [pt.Vec.from_array(a) for a in (xs, ys, zs)]

    def elem(name, got, want):
        got = np.asarray(got.getArray() if hasattr(got, "getArray") else got)
        want = np.asarray(want, dtype=np.float64)
        den = np.maximum(np.abs(want), np.finfo(float).tiny)
        err = float(np.max(np.abs(got - want) / den)) if want.size else 0.0
        rows.append({"method": name, "kind": "elementwise", "max_rel_err": err})
        if not (got.shape == want.shape and err <= SURFACE_ELEM_RTOL):
            raise AssertionError(f"Vec.{name} on the card: relative error {err} "
                                 f"(limit {SURFACE_ELEM_RTOL})")

    def red(name, got, want):
        got, want = np.atleast_1d(np.asarray(got, float)), np.atleast_1d(np.asarray(want, float))
        err = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300)))
        rows.append({"method": name, "kind": "reduction", "max_rel_err": err})
        if not err <= SURFACE_RED_RTOL:
            raise AssertionError(f"Vec.{name} on the card: relative error {err} "
                                 f"(limit {SURFACE_RED_RTOL})")

    with np.errstate(divide="ignore", invalid="ignore"):
        x, y, z = vecs()
        elem("axpby", y.axpby(2.5, -0.75, x), 2.5 * xs + -0.75 * ys)
        x, y, z = vecs()
        elem("axpbypcz", z.axpbypcz(2.0, 3.0, 0.5, x, y), 2.0 * xs + 3.0 * ys + 0.5 * zs)
        x, y, z = vecs()
        elem("maxpy", z.maxpy([0.3, -1.7, 2.1], [x, y, x]),
             ((zs + 0.3 * xs) + -1.7 * ys) + 2.1 * xs)
        for name, fn, want in (
                ("shift", lambda v: v.shift(-0.25), xs - 0.25),
                ("abs", lambda v: v.abs(), np.abs(xs)),
                ("sqrtabs", lambda v: v.sqrtabs(), np.sqrt(np.abs(xs))),
                ("exp", lambda v: v.exp(), np.exp(xs)),
                ("log", lambda v: v.log(), np.log(np.where(xs <= 0, 1.0, xs))),
                ("reciprocal", lambda v: v.reciprocal(),
                 np.where(xs != 0, 1.0 / np.where(xs == 0, 1.0, xs), 0.0)),
                ("zeroEntries", lambda v: v.zeroEntries(), np.zeros(n))):
            elem(name, fn(vecs()[0]), want)
        x, y, z = vecs()
        for name, fn, want in (("pointwiseMult", z.pointwiseMult, xs * ys),
                               ("pointwiseDivide", z.pointwiseDivide, xs / ys),
                               ("pointwiseMax", z.pointwiseMax, np.maximum(xs, ys)),
                               ("pointwiseMin", z.pointwiseMin, np.minimum(xs, ys))):
            got = fn(x, y).getArray()
            fin = np.isfinite(want)           # x / 0: inf or nan on both sides
            if not np.array_equal(np.isnan(got), np.isnan(want)) or \
                    not np.array_equal(got[~fin & ~np.isnan(want)], want[~fin & ~np.isnan(want)]):
                raise AssertionError(f"Vec.{name} on the card: non-finite entries differ")
            elem(name, got[fin], want[fin])
    x, y, z = vecs()
    x.setValues(idx, np.arange(idx.size, dtype=float), pt.InsertMode.ADD_VALUES)
    want = xs.copy()
    np.add.at(want, idx, np.arange(idx.size, dtype=float))
    elem("setValues_add", x, want)
    x.setValues([3, 7, 11], [10.0, 20.0, 30.0])
    x.assemblyBegin()
    x.assemblyEnd()
    x.setValue(5, 2.5, pt.InsertMode.ADD_VALUES)
    want[[3, 7, 11]] = (10.0, 20.0, 30.0)
    want[5] += 2.5
    elem("setValues_insert_and_setValue", x, want)
    x, y, z = vecs()
    x.swap(y)
    elem("swap", x, ys)
    elem("swap_other", y, xs)
    x, y, z = vecs()
    sub = x.getSubVector(sub_idx)
    sub.scale(3.0)
    elem("getSubVector_borrows", x, xs)
    x.restoreSubVector(sub_idx, sub)
    want = xs.copy()
    want[sub_idx] *= 3.0
    elem("restoreSubVector", x, want)
    x, y, z = vecs()
    elem("strideGather", x.strideGather(1, bs=4), xs[1::4])
    x.strideScatter(2, y.strideGather(0, bs=4), bs=4)
    want = xs.copy()
    want[2::4] = ys[0::4]
    elem("strideScatter", x, want)

    x, y, z = vecs()
    red("sum", x.sum(), xs.sum())
    red("mean", x.mean(), xs.mean())
    red("tDot", x.tDot(y), xs @ ys)
    red("maxPointwiseDivide", x.maxPointwiseDivide(y),
        np.max(np.abs(xs) / np.where(ys == 0, 1.0, np.abs(ys))))
    red("strideNorm", [x.strideNorm(1, bs=4), x.strideNorm(3, pt.NormType.NORM_1, bs=4)],
        [np.linalg.norm(xs[1::4]), np.abs(xs[3::4]).sum()])
    red("split_phase", (x.dotBegin(y), x.normBegin(), x.dotEnd(y))[-1],
        [xs @ ys, np.linalg.norm(xs)])
    nrm = x.normalize()
    red("normalize", nrm, np.linalg.norm(xs))
    elem("normalize_vector", x, xs * (1.0 / nrm))
    ties = xs.copy()
    i1, i2 = n // 4, n - 2
    ties[[i1, i2]] = ties.max() + 1.0
    ties[[i1 + 1, i2 + 1]] = ties.min() - 1.0
    t = pt.Vec.from_array(ties)
    if t.max() != (i1, float(ties[i1])) or t.min() != (i1 + 1, float(ties[i1 + 1])):
        raise AssertionError(f"Vec.max/min on the card: {t.max()}, {t.min()}, want the "
                             f"first of each tie ({i1}, {i1 + 1})")
    rows.append({"method": "max/min", "kind": "first index on ties", "ok": True})
    w = x.duplicate()
    w.setArray(x.getArray())
    same = x.equal(w)
    w.setValue(1, float(np.nextafter(x.getArray()[1], 2.0)))
    if not same or x.equal(w):
        raise AssertionError("Vec.equal on the card is not exact")
    rows.append({"method": "equal", "kind": "exact", "ok": True})
    for dtype in ("float64", "float32"):
        pt.init(args=["-real_dtype", "f64" if dtype == "float64" else "f32"])
        v = pt.Vec().setSizes(n).setUp()
        v.setRandom()
        got = v.getArray()
        sha = hashlib.sha256(got.tobytes()).hexdigest()
        rows.append({"method": "setRandom", "kind": "bits", "dtype": str(got.dtype),
                     "sha256": sha})
        if got.dtype != np.dtype(dtype) or sha != SET_RANDOM_SHA256[dtype]:
            raise AssertionError(f"Vec.setRandom ({dtype}) on the card differs from the JAX "
                                 f"package's draw: SHA-256 {sha}")
    return rows


def surface_solve(pt, A, args, configure=None, b=None, B=None):
    """CG on the assembled operator with the PC of `args` (or `configure`)
    for b (numpy; 1 by default), or by matSolve for the columns of B:
    returns the KSP and x (or X, the MatDense's array)."""
    import numpy as np
    pt.init(args=["-ksp_type", "cg", "-ksp_rtol", "1e-8", "-ksp_max_it", "3000", *args])
    ksp = pt.KSP().create()
    ksp.setOperators(A)
    if configure is not None:
        configure(ksp.getPC())
    ksp.setFromOptions()
    if B is not None:
        return ksp, ksp.matSolve(B).getDenseArray()
    x = A.createVecRight()
    ksp.solve(pt.Vec.from_array(np.ones(A.getSize()[0]) if b is None else b), x)
    return ksp, x


def surface_event_sync(pt):
    """log.event(sync=t) around a spin kernel of about 10 ms: with t a CUDA
    tensor the event must last the spin (the card synchronized), without
    sync it times the launch only."""
    import torch
    log = pt.log()
    t = torch.zeros(1, device="cuda")
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with log.event("SurfaceSpinSync", sync=t):
        e0.record()
        torch.cuda._sleep(SPIN_EVENT_CYCLES)
        e1.record()
    spin_ms = e0.elapsed_time(e1)
    with log.event("SurfaceSpinNoSync"):
        torch.cuda._sleep(SPIN_EVENT_CYCLES)
    torch.cuda.synchronize()
    ev_ms = log.get_event("SurfaceSpinSync").time * 1e3
    out = {"spin_ms_cuda_events": spin_ms, "event_ms_with_sync": ev_ms,
           "event_ms_without_sync": log.get_event("SurfaceSpinNoSync").time * 1e3}
    if not ev_ms >= 0.9 * spin_ms:
        raise AssertionError(f"log.event(sync=cuda tensor) took {ev_ms} ms around a "
                             f"{spin_ms} ms spin: it did not wait for the card")
    return out


def phase_surface(pt, pk, A, hist_jacobi, smi, t_start):
    """The rest of the core surface on the card: each Vec method on 128^3
    vectors (surface_vec_checks); multAdd on the assembled 128^3 operator;
    the jacobi variants' diagonals against numpy on its host CSR; CG with
    pbjacobi (bs 1: CG+Jacobi's 184 iterations and history to 1e-6; bs 2
    and 4: converged, relres <= 1e-8), with a shell PC doing Jacobi (184
    and the same history) and matSolve on three columns (each equal to its
    own solve); an event with sync= a CUDA tensor, which must time the
    card's work. Returns the phase's record."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    out = {"phase": "surface", "n": N_MAIN, "nvidia_smi": smi, "vec": surface_vec_checks(pt)}
    pt.init(args=[])
    n = N_MAIN ** 3
    rng = np.random.default_rng(22)
    xs, vs = rng.standard_normal(n), rng.standard_normal(n)
    y = A.createVecLeft()
    A.multAdd(pt.Vec.from_array(xs), pt.Vec.from_array(vs), y)
    d = A.device_data()
    dev = d["vals"].device
    want = pk.csr_spmv_plain(d["indptr"], d["col"], d["vals"], torch.as_tensor(xs, device=dev)) \
        + torch.as_tensor(vs, device=dev)
    err = rel_err(y.array, want)
    if not err <= SURFACE_RED_RTOL or not A.isAssembled() or A.getBlockSize() != 1:
        raise AssertionError(f"Mat.multAdd on the card: error {err}; assembled "
                             f"{A.isAssembled()}, block size {A.getBlockSize()}")
    out["multAdd_rel_err"] = err

    A_sp = A.to_scipy()
    absrow = np.asarray(abs(A_sp).sum(axis=1)).ravel()
    diag = A_sp.diagonal()
    jac = {}
    for variant, want in (("rowmax", abs(A_sp).max(axis=1).toarray().ravel()),
                          ("rowsum", np.asarray(A_sp.sum(axis=1)).ravel()),
                          ("rowl1", diag + (absrow - np.abs(diag)))):
        for use_abs in (False, True):
            pt.init(args=["-pc_type", "jacobi", "-pc_jacobi_type", variant]
                    + (["-pc_jacobi_abs"] if use_abs else []))
            pc = pt.PC().create()
            pc.setOperators(A)
            pc.setFromOptions()
            dd = np.abs(want) if use_abs else want
            inv_want = np.where(dd != 0, 1.0 / np.where(dd == 0, 1.0, dd), 1.0)
            got = pc.device_data()["inv"].cpu().numpy()
            e = float(np.max(np.abs(got - inv_want) / np.abs(inv_want)))
            jac[f"{variant}{'_abs' if use_abs else ''}"] = e
            if not e <= SURFACE_ELEM_RTOL:
                raise AssertionError(f"jacobi {variant} (abs {use_abs}) on the card: {e}")
    out["jacobi_variant_rel_err"] = jac
    del A_sp

    def same_as_jacobi(name, ksp):
        hist = ksp.getConvergenceHistory()
        rel = (float(np.max(np.abs(hist - hist_jacobi) / np.abs(hist_jacobi)))
               if hist.shape == hist_jacobi.shape else math.inf)
        if ksp.getIterationNumber() != ITS_MAIN or not rel <= 1e-6:
            raise AssertionError(f"{name} on the card: {ksp.getIterationNumber()} its (want "
                                 f"{ITS_MAIN}), history vs CG+Jacobi {rel}")
        return rel

    pb = {}
    for bs in (1, 2, 4):
        ts = time.perf_counter()
        ksp, x = surface_solve(pt, A, ["-pc_type", "pbjacobi", "-pc_pbjacobi_block_size",
                                       str(bs)])
        relres = ksp.getResidualNorm() / ksp._rnorm0
        pb[bs] = {"its": ksp.getIterationNumber(), "reason": ksp.getConvergedReason().name,
                  "relres": relres, "setup_and_solve_s": time.perf_counter() - ts}
        if bs == 1:
            pb[bs]["history_rel_diff_vs_jacobi"] = same_as_jacobi("pbjacobi bs 1", ksp)
        elif not ksp.getConvergedReason().converged or not relres <= 1e-8:
            raise AssertionError(f"pbjacobi bs {bs} on the card: {pb[bs]}")
    out["pbjacobi"] = pb

    dinv = 1.0 / A.op().diag()
    ksp, x = surface_solve(pt, A, [], lambda pc: pc.setShellApply(lambda r: dinv * r))
    out["shell_jacobi"] = {"its": ksp.getIterationNumber(),
                           "history_rel_diff_vs_jacobi": same_as_jacobi("shell jacobi", ksp)}

    B = np.stack([np.ones(n), 2.0 * np.ones(n), rng.random(n)], axis=1)
    ksp, X = surface_solve(pt, A, ["-pc_type", "jacobi"], B=B)
    its_cols, errs = [], []
    for j in range(B.shape[1]):
        kj, xj = surface_solve(pt, A, ["-pc_type", "jacobi"], b=B[:, j])
        xj = xj.getArray()
        its_cols.append(kj.getIterationNumber())
        errs.append(float(np.max(np.abs(X[:, j] - xj)) / np.max(np.abs(xj))))
    out["matSolve"] = {"k": B.shape[1], "its": ksp.getIterationNumber(),
                       "its_by_column": its_cols, "reason": ksp.getConvergedReason().name,
                       "max_rel_diff_by_column": errs}
    if ksp.getIterationNumber() != max(its_cols) or not max(errs) <= SURFACE_RED_RTOL:
        raise AssertionError(f"matSolve on the card: {out['matSolve']}")

    out["event_sync"] = surface_event_sync(pt)
    out["seconds"] = time.perf_counter() - t0
    out["seconds_so_far"] = time.perf_counter() - t_start
    return out


# ---------------------------------------------------------------------
# ex56: BAIJ and GAMG on block systems
# ---------------------------------------------------------------------

def ex56_launches_needed(its, nlev, knobs):
    """The launches of one CG + GAMG solve of ex56, set-up included (the
    set-up launches none). Defaults: the V-cycle of mg_launches_needed
    with level 0's five products per application on B1 (A x and A p per
    smoothing, the residual) and its P and R on S2. Knob set: Chebyshev(1,
    1) with the aggregate-block smoother on every level but the coarsest,
    3 products of the level's operator per application (the smoothing's
    A x twice, the residual; B1 on level 0, S2 above), 2 of A1's fused
    Chebyshev steps (agg_block_cheby), no A1 alone, no C1 in any mode;
    the coarse CG+Jacobi's inner steps depend on the data, so S2, K2 and
    K4 are at least the cycle's."""
    napply, fine = its + 1, nlev - 1
    if not knobs:
        need = mg_launches_needed(its, nlev)
        need["csr_spmv"] -= 5 * napply + its
        need.update(bsr_spmv=5 * napply + its, agg_block_apply=0, agg_block_cheby=0,
                    cheby_update_z=0)
        return need, {}
    exact = {"bsr_spmv": 3 * napply + its, "agg_block_cheby": 2 * fine * napply,
             "agg_block_apply": 0, "cheby_update_z": 0, "cheby_update": 0,
             "axpy_normsq": its, "const_stencil": 0}
    at_least = {"csr_spmv": (3 * (fine - 1) + 2 * fine) * napply,
                "triad": 4 * fine * napply + 2 * its, "dot2": 1 + 2 * its}
    return exact, at_least


def ex56_run(pt, ne, mode):
    """PETSc's ex56 through the user's entry points (the port's example's
    steps, petsc_tpu_torch/examples/ex56.py main): assemble, from_scipy,
    setBlockSize(3) (kind aij_bsr), MatNullSpace.createRigidBody, CG in the
    unpreconditioned norm to rtol 1e-4; every launch count set to 0 just
    before the set-up and read just after the solve. Returns (ksp, A_sp,
    b_np, b, x, launches, seconds, the node coordinates)."""
    import torch
    from petsc_tpu_torch.examples import ex56
    secs = {}
    t0 = time.perf_counter()
    A_sp, b_np, coords = ex56.assemble(ne)
    secs["assemble_s"] = time.perf_counter() - t0
    pt.init(args=["-ne", str(ne)] + (EX56_DEFAULTS if mode == "defaults" else EX56_KNOBS))
    t0 = time.perf_counter()
    A = pt.MatAIJ.from_scipy(A_sp)
    torch.cuda.synchronize()
    secs["from_scipy_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    A.setBlockSize(3)
    torch.cuda.synchronize()
    secs["setBlockSize_s"] = time.perf_counter() - t0
    if A.meta[0] != "aij_bsr" or A.getBlockSize() != 3 or "vals" in A.device_data():
        raise AssertionError(f"ex56 ne {ne}: kind {A.meta[0]}, bs {A.getBlockSize()}, "
                             f"device keys {sorted(A.device_data())}")
    c = coords[:, ::-1].copy() if mode == "transposed" else coords
    A.setNearNullSpace(pt.MatNullSpace.createRigidBody(c))
    ksp = pt.KSP().create()
    ksp.setOperators(A)
    ksp.setNormType("unpreconditioned")
    ksp.setTolerances(rtol=EX56_RTOL, max_it=200)
    ksp.setFromOptions()
    b = pt.Vec.from_array(b_np)
    x = A.createVecRight()
    torch.cuda.synchronize()
    reset_launches()
    pt.log().reset()
    t0 = time.perf_counter()
    ksp.setUp()
    torch.cuda.synchronize()
    secs["setup_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ksp.solve(b, x)
    torch.cuda.synchronize()
    secs["first_solve_s"] = time.perf_counter() - t0
    return ksp, A_sp, b_np, b, x, launch_counts(), secs, coords


def check_ex56(ksp, A_sp, b_np, x, key):
    """The contract of `python ex56_contract.py NE MODE` (EX56_CONTRACT):
    its, reason, history to 1e-6, rows and aggregates per level, the
    level-0 aggregates' hash, a true residual no worse than 10x the
    reference's, finite values."""
    import hashlib
    import numpy as np
    import torch
    want = EX56_CONTRACT[key]
    its, reason = ksp.getIterationNumber(), ksp.getConvergedReason().name
    hist, wh = ksp.getConvergenceHistory(), np.array(want["history"])
    hist_rel = (float(np.max(np.abs(hist - wh) / wh)) if hist.shape == wh.shape else math.inf)
    levels = ksp.getPC()._impl.levels
    rows = tuple(lev.A.getSize()[0] for lev in levels)
    aggs = tuple(int(lev.agg.max()) + 1 for lev in levels[:-1])
    sha = hashlib.sha256(np.asarray(levels[0].agg, dtype=np.int64).tobytes()).hexdigest()
    xs = x.array.double().cpu().numpy()
    true_rel = float(np.linalg.norm(b_np - A_sp @ xs) / np.linalg.norm(b_np))
    if (its != want["its"] or reason != "CONVERGED_RTOL" or not hist_rel <= EX56_HIST_TOL
            or rows != want["rows"] or aggs != want["aggregates"] or sha != want["agg0_sha256"]
            or not true_rel <= 10 * want["true_relres"]
            or not bool(torch.isfinite(x.array).all())):
        raise AssertionError(
            f"ex56 {key}: its {its} (want {want['its']}), {reason}, history vs the reference "
            f"{hist_rel}, rows {rows} (want {want['rows']}), aggregates {aggs} (want "
            f"{want['aggregates']}), agg0 hash {sha == want['agg0_sha256']}, true relres "
            f"{true_rel} (the reference's {want['true_relres']})")
    return {"its": its, "reason": reason, "history_rel_diff_vs_reference": hist_rel,
            "rows": rows, "aggregates": aggs, "agg0_sha256_equal": True,
            "true_relres": true_rel, "reference_true_relres": want["true_relres"],
            "emax": [lev.emax for lev in levels[:-1]]}


def ex56_case(pt, ne, mode, profile=False):
    """One ex56 run checked against its contract and its launches; with
    profile, also the warm solve (best of 3) and one profiled warm solve.
    Returns (the record, ksp, launches, profile or None, the problem
    (A_sp, b_np, coords))."""
    ksp, A_sp, b_np, b, x, launches, secs, coords = ex56_run(pt, ne, mode)
    chk = check_ex56(ksp, A_sp, b_np, x, (ne, mode))
    nlev = len(ksp.getPC()._impl.levels)
    exact, at_least = ex56_launches_needed(chk["its"], nlev, mode != "defaults")
    bad = {k: (launches[k], v) for k, v in exact.items() if launches[k] != v}
    bad.update({k: (launches[k], f">= {v}") for k, v in at_least.items() if launches[k] < v})
    if bad:
        raise AssertionError(f"ex56 ne {ne} {mode}: launches (got, want): {bad}")
    events = {}
    for name in ("PCGAMGSetUp_native", "PCGAMGSetUp_download", "PCGAMGSetUp_graph",
                 "PCGAMGSetUp_coarsen", "PCGAMGSetUp_prol0", "PCGAMGSetUp_emax",
                 "PCGAMGSetUp_smooth_prol", "PCGAMGSetUp_SpGEMM", "PCMGSetUp_agg_blocks",
                 "PCMGSetUp_emax", "PCMGSetUp_LU"):
        ev = pt.log().get_event(name)
        if ev is not None and ev.count:
            events[name] = ev.time
    rec = {"ne": ne, "mode": mode, "rows": A_sp.shape[0], "nnz": int(A_sp.nnz), **secs,
           **chk, "setup_events_s": events, "launches": {k: v for k, v in launches.items() if v},
           "launches_exact": exact, "launches_at_least": at_least}
    prof = None
    if profile:
        warm = warm_ms(ksp, b, x)
        check_ex56(ksp, A_sp, b_np, x, (ne, mode))
        prof = profile_solve(ksp, b, x, warm)
        check_ex56(ksp, A_sp, b_np, x, (ne, mode))
        rec.update(warm_ms_best_of_3=warm, ms_per_it=warm / chk["its"],
                   device_busy_ms=prof["device_busy_ms"],
                   busy_share=prof["busy_share_of_warm"],
                   device_events=prof["device_events"])
    return rec, ksp, launches, prof, (A_sp, b_np, coords)


def _random_bsr(nbr, bs, dtype, seed, long_row=None, empty_row=None):
    """A random BSR on the card: rows of 1 to 7 blocks, with a row of
    long_row[1] blocks and an empty row where asked."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 8, nbr)
    if long_row is not None:
        lens[long_row[0]] = long_row[1]
    if empty_row is not None:
        lens[empty_row] = 0
    cols = [np.sort(rng.choice(nbr, size=int(L), replace=False)) for L in lens]
    ptr = np.concatenate([[0], np.cumsum(lens)])
    t = lambda a, dt=dtype: torch.as_tensor(a, dtype=dt, device="cuda")  # noqa: E731
    return (t(ptr, torch.int64), t(np.concatenate(cols).astype(np.int32), torch.int32),
            t(rng.standard_normal((int(ptr[-1]), bs, bs))), t(rng.standard_normal(nbr * bs)))


def earlier_bsr(earlier, ip, bc, v, x):
    """y = A x by B1's earlier per-output design (earlier_kernels/), on the
    current stream; raises on a CUDA error."""
    import torch
    from petsc_tpu_torch.ops import cuda_build
    bs = v.shape[1]
    y = torch.empty((ip.numel() - 1) * bs, dtype=x.dtype, device=x.device)
    fn = getattr(earlier, "ptt_earlier_bsr_spmv_" + ("f64" if x.dtype == torch.float64
                                                     else "f32"))
    cuda_build.check("earlier bsr_spmv", fn(y.data_ptr(), ip.data_ptr(), bc.data_ptr(),
                                            v.data_ptr(), x.data_ptr(), ip.numel() - 1, bs,
                                            x.get_device(),
                                            torch.cuda.current_stream().cuda_stream))
    return y


def earlier_agg(earlier, tab, work, r):
    """z = M^-1 r by A1's earlier 16-row design (earlier_kernels/) on A1's
    tables with that design's work list (earlier_agg_work); raises on a
    CUDA error."""
    import torch
    from petsc_tpu_torch.ops import cuda_build
    z = torch.empty_like(r)
    fn = getattr(earlier, "ptt_earlier_agg_block_apply_" + ("f64" if r.dtype == torch.float64
                                                            else "f32"))
    cuda_build.check("earlier agg_block_apply", fn(
        z.data_ptr(), r.data_ptr(), tab["dofs"].data_ptr(), tab["dptr"].data_ptr(),
        tab["inv"].data_ptr(), tab["iptr"].data_ptr(), work.data_ptr(), work.numel() // 3,
        tab["max_k"], r.get_device(), torch.cuda.current_stream().cuda_stream))
    return z


def b1_rows(bk, pk, A, A_sp, flush, earlier):
    """B1 against its plain version (equal bits) on ex56 ne 64's operator in
    f64 and f32, each timed with its bound, the plain version, the earlier
    per-output design (equal bits too) in turns (earlier, new, new,
    earlier), then S2 and torch.sparse_csr_tensor @ x (the library call)
    on the same matrix as CSR and torch.sparse_bsr_tensor @ x (cuSPARSE's
    BSR product), each checked first (10 x 1e-12 / 1e-5: other orders);
    then random BSRs of bs 2, 3, 5 and 6 over 30,000 block rows with a row
    of 500 blocks and an empty row, equal bits."""
    import numpy as np
    import torch
    d = A.device_data()
    ip, bc = d["bptr"], d["bcol"]
    g = torch.Generator(device="cuda").manual_seed(56)
    rows, main = [], None
    cip = torch.as_tensor(A_sp.indptr.astype(np.int64), device="cuda")
    ccol = torch.as_tensor(A_sp.indices.astype(np.int32), device="cuda")
    for dt in (torch.float64, torch.float32):
        name = "float64" if dt == torch.float64 else "float32"
        v = d["bvals"].to(dt)
        x = torch.rand(A_sp.shape[1], generator=g, device="cuda", dtype=torch.float64).to(dt)
        y, yp = bk.bsr_spmv(ip, bc, v, x), bk.bsr_spmv_plain(ip, bc, v, x)
        err = rel_err(y, yp)
        if not (torch.equal(y, yp) and torch.equal(earlier_bsr(earlier, ip, bc, v, x), yp)):
            raise AssertionError(f"B1 ex56 ne 64 {name}: {err} from its plain version "
                                 "(or the earlier design's bits differ)")
        isz = v.element_size()
        nbytes = v.numel() * isz + bc.numel() * 4 + ip.numel() * 8 + 2 * x.numel() * isz
        b_ms, b_by = bound(nbytes, 2 * v.numel(), name)
        turns = [time_ms(fn, flush) for fn in (
            lambda: earlier_bsr(earlier, ip, bc, v, x), lambda: bk.bsr_spmv(ip, bc, v, x),
            lambda: bk.bsr_spmv(ip, bc, v, x), lambda: earlier_bsr(earlier, ip, bc, v, x))]
        ms, earlier_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        # S2 and the library's CSR product on the same operator stored as scalar CSR
        cval = torch.as_tensor(A_sp.data, dtype=dt, device="cuda")
        M = torch.sparse_csr_tensor(cip.int(), ccol, cval, size=tuple(A_sp.shape))
        for what, fn in (("S2", lambda: pk.csr_spmv(cip, ccol, cval, x)),
                         ("torch.sparse_csr_tensor @ x", lambda: M @ x)):
            e = rel_err(fn(), yp)
            if not e <= 10 * TOL[name]:
                raise AssertionError(f"{what} on ex56 ne 64's CSR {name}: {e} from B1's plain "
                                     "version")
        s2_ms = time_ms(lambda: pk.csr_spmv(cip, ccol, cval, x), flush)
        lib_ms = time_ms(lambda: M @ x, flush)
        s2_bytes = cval.numel() * (isz + 4) + cip.numel() * 8 + 2 * x.numel() * isz
        del M, cval
        # the library's BSR product (cuSPARSE bsrmv through torch.sparse)
        bsr_ms, bsr_note = None, "torch.sparse_bsr_tensor(...) @ x"
        try:
            M = torch.sparse_bsr_tensor(ip.to(torch.int32), bc, v, size=tuple(A_sp.shape))
            e = rel_err((M @ x[:, None])[:, 0], yp)
            if e > 10 * TOL[name]:
                raise AssertionError(f"disagrees: {e}")
            bsr_ms = time_ms(lambda: M @ x[:, None], flush)
            del M
        except Exception as exc:             # noqa: BLE001 - recorded, not hidden
            bsr_note += f": not measured ({type(exc).__name__}: {str(exc)[:200]})"
        r = {"name": "bsr_spmv", "dtype": name, "shape": "ex56 ne 64", "rows": A_sp.shape[0],
             "blocks": int(bc.numel()), "bs": 3, "equal_bits": True, "max_abs_err": err,
             "ms": ms, "plain_ms": time_ms(lambda: bk.bsr_spmv_plain(ip, bc, v, x), flush, 3),
             "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
             "share_of_bound": b_ms / ms, "earlier_ms": earlier_ms, "turns_ms": turns,
             "earlier_share_of_bound": b_ms / earlier_ms,
             "launch": bk.bsr_launch_config(bc.numel(), 3, dt, "cuda"),
             "library_ms": lib_ms, "library": "torch.sparse_csr_tensor(...) @ x on the CSR",
             "library_bsr_ms": bsr_ms, "library_bsr": bsr_note,
             "s2_same_matrix_ms": s2_ms, "s2_bound_ms": bound(s2_bytes, 2 * A_sp.nnz, name)[0]}
        rows.append(r)
        main = main or r
    del cip, ccol
    for bs in (2, 3, 5, 6):
        for dt in (torch.float64, torch.float32):
            name = "float64" if dt == torch.float64 else "float32"
            ip2, bc2, v2, x2 = _random_bsr(30000, bs, dt, bs, long_row=(3, 500), empty_row=9)
            y, yp = bk.bsr_spmv(ip2, bc2, v2, x2), bk.bsr_spmv_plain(ip2, bc2, v2, x2)
            if not torch.equal(y, yp) or float(y.view(-1, bs)[9].abs().max()) != 0.0:
                raise AssertionError(f"B1 bs {bs} {name}: {rel_err(y, yp)} from its plain "
                                     "version")
            rows.append({"name": "bsr_spmv", "dtype": name, "bs": bs,
                         "shape": "30000 block rows, one of 500 blocks, one empty",
                         "equal_bits": True, "max_abs_err": 0.0})
    return rows, main


def earlier_agg_work(tab):
    """The work list of A1's earlier 16-row design (earlier_kernels/
    agg_block_16rows.cu) for A1's tables: one (block, first row, rows)
    item per 16 rows of each block, on the tables' device."""
    import numpy as np
    import torch
    ks = (tab["dptr"][1:] - tab["dptr"][:-1]).cpu().numpy()
    per = -(-ks // 16)
    blk = np.repeat(np.arange(len(ks)), per)
    first = (np.arange(len(blk)) - np.repeat(np.cumsum(per) - per, per)) * 16
    work = np.stack([blk, first, np.minimum(16, ks[blk] - first)], axis=1).astype(np.int32)
    return torch.as_tensor(work.reshape(-1), device=tab["dofs"].device)


def a1_rows(bk, cases, flush, earlier):
    """A1 against its plain version (f64 1e-12, f32 1e-5: the warp sums in
    another order) on each (label, tables, timed) case; a timed case also
    gets its time with its bound, the plain version, the earlier 16-row
    design in turns (earlier, new, new, earlier; also held to the plain
    version) and torch.bmm on the reference's padded table (the product
    alone). Returns the rows."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(24)
    rows = []
    for label, tab, timed in cases:
        n = tab["dofs"].numel()
        for dt in (torch.float64, torch.float32):
            name = "float64" if dt == torch.float64 else "float32"
            t = {**tab, "inv": tab["inv"].to(dt)}
            r = torch.rand(n, generator=g, device="cuda", dtype=torch.float64).to(dt)
            z, zp = bk.agg_block_apply(t, r), bk.agg_block_apply_plain(t, r)
            err = rel_err(z, zp)
            if err > TOL[name]:
                raise AssertionError(f"A1 {label} {name}: {err} from its plain version")
            nblk = t["dptr"].numel() - 1
            row = {"name": "agg_block_apply", "dtype": name, "shape": label, "dofs": n,
                   "blocks": nblk, "max_k": t["max_k"], "sum_k2": int(t["inv"].numel()),
                   "work_items": t["work"].numel() // 3, "max_abs_err": err}
            rows.append(row)
            if not timed:
                continue
            isz = r.element_size()
            nbytes = (t["inv"].numel() * isz + n * (2 * isz + 4) + t["work"].numel() * 4
                      + (t["dptr"].numel() + t["iptr"].numel()) * 8)
            b_ms, b_by = bound(nbytes, 2 * t["inv"].numel(), name)
            kmax = t["max_k"]
            lib_ms, lib_note = None, f"torch.bmm on the padded ({nblk}, {kmax}, {kmax}) table"
            try:
                Pd = torch.zeros(nblk, kmax, kmax, dtype=dt, device="cuda")
                Rd = torch.zeros(nblk, kmax, 1, dtype=dt, device="cuda")
                a0 = 0
                for idx, i0, na, k in t["groups"]:
                    Pd[a0:a0 + na, :k, :k] = t["inv"][i0:i0 + na * k * k].view(na, k, k)
                    Rd[a0:a0 + na, :k, 0] = r[idx]
                    a0 += na
                lib_ms = time_ms(lambda: torch.bmm(Pd, Rd), flush)
                del Pd, Rd
            except Exception as exc:             # noqa: BLE001 - recorded, not hidden
                lib_note += f": not measured ({type(exc).__name__}: {str(exc)[:200]})"
            torch.cuda.empty_cache()
            old_work = earlier_agg_work(t)
            e_err = rel_err(earlier_agg(earlier, t, old_work, r), zp)
            if e_err > TOL[name]:
                raise AssertionError(f"A1's earlier design {label} {name}: {e_err}")
            turns = [time_ms(fn, flush) for fn in (
                lambda: earlier_agg(earlier, t, old_work, r), lambda: bk.agg_block_apply(t, r),
                lambda: bk.agg_block_apply(t, r), lambda: earlier_agg(earlier, t, old_work, r))]
            ms, earlier_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
            row.update(ms=ms, plain_ms=time_ms(lambda: bk.agg_block_apply_plain(t, r), flush, 3),
                       bound_ms=b_ms, bound_by=b_by, bytes=nbytes, share_of_bound=b_ms / ms,
                       earlier_ms=earlier_ms, turns_ms=turns,
                       earlier_share_of_bound=b_ms / earlier_ms,
                       earlier_work_items=old_work.numel() // 3, library_ms=lib_ms,
                       library=lib_note)
    return rows


def cheby_z_rows(pk, n, flush):
    """C1's z modes (kernel cheby_update_z) against their plain version on
    the same inputs (f64 1e-12, f32 1e-5 relative on p and x) at the knob
    set's level-0 length n, each timed after the clean flush beside the
    plain version and its bound (first_z reads x and z and writes p and x,
    step_z also reads p). No single PyTorch call computes the update
    (library_ms None). Returns (rows, the f64 step_z row)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(78)
    rows, main = [], None
    for dtype in (torch.float64, torch.float32):
        dn = str(dtype).replace("torch.", "")
        isz = torch.empty((), dtype=dtype).element_size()
        z, p0, x0 = (torch.rand(n, generator=gen, device="cuda", dtype=dtype) for _ in range(3))
        for mode in ("first_z", "step_z"):
            kw = {"a": 0.6} if mode == "step_z" else {}
            k, q = [p0.clone(), x0.clone()], [p0.clone(), x0.clone()]
            pk.cheby_update_z(mode, *k, z, 0.3, 0.9, **kw)
            pk.cheby_update_z_plain(mode, *q, z, 0.3, 0.9, **kw)
            torch.cuda.synchronize()
            err = max(rel_err(a, c) for a, c in zip(k, q))
            if not err <= TOL[dn]:
                raise AssertionError(f"cheby_update_z {mode} {dn} n={n}: rel err {err}")
            nbytes = (4 if mode == "first_z" else 5) * n * isz
            b_ms, b_by = bound(nbytes, (3 if mode == "first_z" else 5) * n, dn)
            row = {"name": "cheby_update_z", "mode": mode, "dtype": dn, "n": n,
                   "rel_err": err, "tol": TOL[dn],
                   "max_abs_err": max(float((a - c).abs().max()) for a, c in zip(k, q)),
                   "ms": time_ms(lambda: pk.cheby_update_z(mode, *k, z, 0.3, 0.9, **kw), flush),
                   "plain_ms": time_ms(
                       lambda: pk.cheby_update_z_plain(mode, *q, z, 0.3, 0.9, **kw), flush),
                   "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
            row["share_of_bound"] = b_ms / row["ms"]
            rows.append(row)
            if (dn, mode) == ("float64", "step_z"):
                main = row
    return rows, main


AGG_CHEBY_KW = {"first_z": {"c": 0.3, "beta": 0.9}, "step_z": {"c": 0.3, "beta": 0.9, "a": 0.6}}


def ragged_agg_tables(device, dtype, seed=7):
    """A1's tables over random blocks of 1 (loose dofs), 3, 16, 17, 96, 300
    and 700 dofs (every mapping of the kernel: lane groups, warps, the
    whole thread block over several items), the dofs a random permutation,
    random inverses."""
    import numpy as np
    from petsc_tpu_torch.ops import block_kernels as bk
    rng = np.random.default_rng(seed)
    ks = [1] * 50 + [3] * 40 + [16] * 4 + [17] * 5 + [96] * 3 + [300] * 2 + [700]
    perm = rng.permutation(sum(ks))
    dptr = np.concatenate([[0], np.cumsum(ks)])
    dof_lists = [np.sort(perm[a:b]) for a, b in zip(dptr[:-1], dptr[1:])]
    inv = np.concatenate([rng.standard_normal(k * k) for k in ks])
    return bk.agg_block_tables(dof_lists, inv, device, dtype)


def a1_cheby_rows(bk, pk, cases, flush):
    """A1's fused Chebyshev step (kernel agg_block_cheby) on each (label,
    tables) case in f64 and f32, modes first_z and step_z: equal bits with
    A1 followed by C1's z mode (the earlier two-launch design), within A1's
    tolerance (f64 1e-12, f32 1e-5 relative on p and x) of its plain
    version, timed in turns with the two launches (two, fused, fused, two)
    beside the plain version and its bound: A1's bytes without z's store,
    plus x read and written and p written, and p read in step_z. No single
    PyTorch call computes it (library_ms None). Returns the rows."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(16)
    rows = []
    for label, tab in cases:
        n = tab["dofs"].numel()
        for dt in (torch.float64, torch.float32):
            name = "float64" if dt == torch.float64 else "float32"
            t = {**tab, "inv": tab["inv"].to(dt)}
            r, p0, x0 = (torch.rand(n, generator=g, device="cuda", dtype=torch.float64).to(dt)
                         for _ in range(3))
            isz = r.element_size()
            a1_bytes = (t["inv"].numel() * isz + n * (2 * isz + 4) + t["work"].numel() * 4
                        + (t["dptr"].numel() + t["iptr"].numel()) * 8)
            for mode, kw in AGG_CHEBY_KW.items():
                def fused(p, x, mode=mode, kw=kw):
                    return bk.agg_block_cheby(t, r, mode, p, x, **kw)

                def two(p, x, mode=mode, kw=kw):
                    return pk.cheby_update_z(mode, p, x, bk.agg_block_apply(t, r), **kw)

                out = {}
                for what, fn in (("fused", fused), ("two", two),
                                 ("plain", lambda p, x, mode=mode, kw=kw:
                                  bk.agg_block_cheby_plain(t, r, mode, p, x, **kw))):
                    out[what] = (p0.clone(), x0.clone())
                    fn(*out[what])
                torch.cuda.synchronize()
                equal = all(torch.equal(a, b) for a, b in zip(out["fused"], out["two"]))
                err = max(rel_err(a, b) for a, b in zip(out["fused"], out["plain"]))
                if not equal or not err <= TOL[name]:
                    raise AssertionError(f"agg_block_cheby {label} {name} {mode}: equal bits with "
                                         f"A1 then C1z {equal}, {err} from its plain version")
                nbytes = a1_bytes - n * isz + (3 if mode == "first_z" else 4) * n * isz
                b_ms, b_by = bound(nbytes, 2 * t["inv"].numel()
                                   + (3 if mode == "first_z" else 5) * n, name)
                pt, xt = p0.clone(), x0.clone()
                turns = [time_ms(fn, flush) for fn in (
                    lambda: two(pt, xt), lambda: fused(pt, xt), lambda: fused(pt, xt),
                    lambda: two(pt, xt))]
                ms, earlier_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
                rows.append({
                    "name": "agg_block_cheby", "mode": mode, "dtype": name, "shape": label,
                    "dofs": n, "blocks": t["dptr"].numel() - 1, "max_k": t["max_k"],
                    "equal_bits": True, "rel_err": err, "tol": TOL[name],
                    "max_abs_err": max(float((a - b).abs().max())
                                       for a, b in zip(out["fused"], out["plain"])),
                    "ms": ms, "earlier_ms": earlier_ms, "turns_ms": turns,
                    "earlier": "A1 (agg_block_apply) then C1z (cheby_update_z): two launches",
                    "plain_ms": time_ms(lambda: bk.agg_block_cheby_plain(
                        t, r, mode, pt, xt, **kw), flush, 3),
                    "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                    "share_of_bound": b_ms / ms, "earlier_share_of_bound": b_ms / earlier_ms,
                    "library_ms": None})
    return rows


def phase_ex56(pt, smi, t_start, flush, earlier):
    """PETSc's ex56 on the card: the defaults at full width (ne 64), B1's
    rows on its operator and A1's on its tables over the defaults' level-0
    aggregates; the knob set at ne 11, 11 with the transposed modes, and
    24, A1's rows on every level's tables of ne 24's solve and C1z's at
    its level-0 length, A1's fused step on all those tables and on random
    ones. Returns (the record, B1's, A1's, C1z's and the fused step's main
    rows, the defaults' launches and profile, the knob set's (ne 24)
    launches and profile, and ne 64's problem for phase sbaij: (A_sp,
    b_np, coords, the defaults' history, the BSR's block count))."""
    import torch
    from petsc_tpu_torch.ops import block_kernels as bk
    from petsc_tpu_torch.pc.mg import _agg_blocks_host
    from petsc_tpu_torch.ops import pallas_kernels as pk
    t0 = time.perf_counter()
    out = {"phase": "ex56", "nvidia_smi": smi, "rtol": EX56_RTOL, "norm": "unpreconditioned"}
    rec, ksp, launches, prof, (A_asm, b_np, coords) = ex56_case(pt, 64, "defaults",
                                                                 profile=True)
    out["defaults_ne64"] = rec
    out["defaults_ne64_profile"] = prof
    A = ksp.getOperators()[0]
    ne64 = (A_asm, b_np, coords, ksp.getConvergenceHistory(), A.device_data()["bcol"].numel())
    A_sp = A.to_scipy()
    out["bsr_spmv_checks"], b1 = b1_rows(bk, pk, A, A_sp, flush, earlier)
    # A1 at full width: the ragged tables of the aggregate-block smoother
    # over the defaults' level-0 aggregates on ne 64's operator
    t1 = time.perf_counter()
    tab64 = bk.agg_block_tables(*_agg_blocks_host(A_sp, ksp.getPC()._impl.levels[0].agg, 3),
                                "cuda", torch.float64)
    out["agg_blocks_ne64_host_s"] = time.perf_counter() - t1
    label64 = "ex56 ne 64 level 0, the defaults' aggregates"
    a1_checks = a1_rows(bk, [(label64, tab64, True)], flush, earlier)
    fused_checks = a1_cheby_rows(bk, pk, [(label64, tab64)], flush)
    del ksp, A, A_sp, tab64
    torch.cuda.empty_cache()
    out["defaults_seconds"] = time.perf_counter() - t0
    for ne, mode in ((11, "knobs"), (11, "transposed")):
        out[f"{mode}_ne{ne}"] = ex56_case(pt, ne, mode)[0]
    rec, ksp, k_launches, k_prof, _ = ex56_case(pt, 24, "knobs", profile=True)
    out["knobs_ne24"] = rec
    out["knobs_ne24_profile"] = k_prof
    # A1 on every level's tables of the ne 24 solve, level 0 timed
    levels = [ld for ld in ksp.getPC()._data["levels"] if "agg" in ld]
    a1_checks = a1_rows(bk, [(f"ex56 ne 24 level {i}", ld["agg"], i == 0)
                             for i, ld in enumerate(levels)], flush, earlier) + a1_checks
    if len(levels) != len(ksp.getPC()._impl.levels) - 1:
        raise AssertionError(f"ex56 ne 24 knobs: {len(levels)} levels with A1's tables")
    out["agg_block_apply_checks"] = a1_checks
    a1 = a1_checks[0]
    n0 = levels[0]["agg"]["dofs"].numel()
    out["cheby_update_z_checks"], c1z = cheby_z_rows(pk, n0, flush)
    fused_checks = a1_cheby_rows(
        bk, pk, [(f"ex56 ne 24 level {i}", ld["agg"]) for i, ld in enumerate(levels)]
        + [("random blocks of 1 to 700 dofs", ragged_agg_tables("cuda", torch.float64))],
        flush) + fused_checks
    out["agg_block_cheby_checks"] = fused_checks
    a1c = next(r for r in fused_checks if (r["shape"], r["dtype"], r["mode"])
               == ("ex56 ne 24 level 0", "float64", "step_z"))
    del ksp, levels
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    out["seconds_so_far"] = time.perf_counter() - t_start
    return out, b1, a1, c1z, a1c, launches, prof, k_launches, k_prof, ne64


def ex45_launches_needed(its, levels, pc):
    """The launches of one run of ex45 (PETSc's ex45 or its dof-3 form),
    from init to the end of the first solve: K1 once (init); K8 twice per
    setValuesCOO (v[perm] and the diagonal), on every level of PCMG from
    the DM ("mg": each level rediscretized) and once otherwise ("gamg", and
    "dof3", whose coarse levels are Galerkin products); and the solve of
    grid_launches_needed: its + 1 PC applications, each with, on every level
    but the coarsest, 5 products with the level's A (V1 on a grid level, B1
    on a block one, S2 above), 4 C1, 2 K2 and the transfers (a Q1 P: one
    Q1P and one Q1R; an aggregation P: two S2); CG's product with level 0's
    A, two K2, one K3 and two K4 per iteration and one K4 before them. GAMG's
    head adds, for each of its levels, 27 probes (a Q1P, a product, a Q1R)
    and 10 Lanczos products; PCMG's bounds come from the host."""
    napply = its + 1
    probes, lanczos = (27, 10) if pc == "gamg" else (0, 0)
    need = dict.fromkeys(GRID_KERNELS + ("bsr_spmv", "gather", "probe"), 0)
    for lev in levels[:-1]:
        a = product_kernel(lev.A.meta)
        need[a] += 5 * napply
        need["cheby_update"] += 4 * napply
        need["triad"] += 2 * napply
        if lev.P.meta[0] == "interp_q1":
            need["q1_prolong"] += napply + probes
            need["q1_restrict"] += napply + probes
            need[a] += probes + lanczos
        else:
            need["csr_spmv"] += 2 * napply
    need[product_kernel(levels[0].A.meta)] += its
    need["triad"] += 2 * its
    need["axpy_normsq"] += its
    need["dot2"] += 1 + 2 * its
    need["probe"] = 1
    need["gather"] = 2 * (len(levels) if pc == "mg" else 1)
    return need


def set_up_events(pt):
    """Every event of the profiler's main stage with its host seconds."""
    stage = pt.log()._stages.get("Main Stage")
    return {k: e.time for k, e in (stage.events.items() if stage else ()) if e.count}


def check_ex45(ksp, A_sp, b_np, x, key):
    """The contract of ex45_contract.py (EX45_CONTRACT[key]): its, reason,
    history to 1e-6, rows and operator and transfer kinds per level, nnz, a
    true residual no worse than 10x the reference's, finite values."""
    import numpy as np
    import torch
    want = EX45_CONTRACT[key]
    its, reason = ksp.getIterationNumber(), ksp.getConvergedReason().name
    hist, wh = ksp.getConvergenceHistory(), np.array(want["history"])
    hist_rel = (float(np.max(np.abs(hist - wh) / wh)) if hist.shape == wh.shape else math.inf)
    levels = ksp.getPC()._impl.levels
    hier = {"rows": tuple(lev.A.getSize()[0] for lev in levels),
            "kinds": tuple(lev.A.meta[0] for lev in levels),
            "p_kinds": tuple(lev.P.meta[0] for lev in levels[:-1])}
    bad = {k: (v, want[k]) for k, v in hier.items() if v != want[k]}
    xs = x.array.double().cpu().numpy()
    true_rel = float(np.linalg.norm(b_np - A_sp @ xs) / np.linalg.norm(b_np))
    if (its != want["its"] or reason != "CONVERGED_RTOL" or not hist_rel <= EX45_HIST_TOL
            or bad or A_sp.nnz != want["nnz"] or not true_rel <= 10 * want["true_relres"]
            or not bool(torch.isfinite(x.array).all())):
        raise AssertionError(
            f"ex45 {key}: its {its} (want {want['its']}), {reason}, history vs the reference "
            f"{hist_rel}, hierarchy (got, want) {bad}, nnz {A_sp.nnz} (want {want['nnz']}), "
            f"true relres {true_rel} (the reference's {want['true_relres']})")
    return {"its": its, "reason": reason, "history_rel_diff_vs_reference": hist_rel,
            **hier, "nnz": int(A_sp.nnz), "true_relres": true_rel,
            "reference_true_relres": want["true_relres"],
            "emax": [lev.emax for lev in levels[:-1]]}


def ex45_case(pt, pc, profile=True):
    """PETSc's ex45 at 129^3 through the steps of the port's example
    (petsc_tpu_torch/examples/ex45.py main): init, DMDA.create and
    setFromOptions (-da_grid_x|y|z 129), KSP.setDM, setComputeRHS,
    setComputeOperators, setFromOptions, ksp.solve() with no arguments;
    every launch count set to 0 just before init and read just after the
    solve, held to ex45_launches_needed; the contract; the host seconds by
    event (the COO assembly in compute_operators on each level, PCSetUp);
    then the warm solve (best of 3) and one profiled warm solve. Returns
    (the record, launches, profile, the level-0 operator)."""
    import torch
    from petsc_tpu_torch.examples import ex45
    grid = [a for ax in "xyz" for a in (f"-da_grid_{ax}", str(EX45_N))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    pt.init(args=grid + EX45_ARGS + ["-pc_type", pc])
    pt.log().reset()
    da = pt.DMDA.create(3, (7, 7, 7), dof=1, stencil_width=1)
    da.setFromOptions()
    ksp = pt.KSP().create()
    ksp.setDM(da)
    ksp.setComputeRHS(ex45.compute_rhs)
    ksp.setComputeOperators(ex45.compute_operators)
    ksp.setFromOptions()
    x = ksp.solve()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = launch_counts()
    events = set_up_events(pt)
    A = ksp.getOperators()[0]
    b = da.createGlobalVector()
    ex45.compute_rhs(ksp, b)
    A_sp = A.to_scipy()
    b_np = b.array.double().cpu().numpy()
    chk = check_ex45(ksp, A_sp, b_np, x, pc)
    levels = ksp.getPC()._impl.levels
    need = ex45_launches_needed(chk["its"], levels, pc)
    bad = {k: (launches[k], v) for k, v in need.items() if launches[k] != v}
    if bad:
        raise AssertionError(f"ex45 {pc}: launches (got, want): {bad}")
    v1 = {str(lev.A.meta[1]): lev.A.op().mult.kernel for lev in levels
          if product_kernel(lev.A.meta) == "dnd_stencil"}
    if set(v1.values()) != {"window"}:
        raise AssertionError(f"ex45 {pc}: V1's kernel per level: {v1}")
    rec = {"pc": pc, "n": EX45_N, "rows": A_sp.shape[0], **chk,
           "first_solve_s_incl_init_and_setup": first_s, "setup_events_s": events,
           "compute_operators_s": {"level0": events.get("KSPComputeOperators"),
                                   "coarse_levels": events.get("PCMGSetUp_compute_operators")},
           "pc_setup_s": events.get(f"PCSetUp_{pc}"), "ksp_solve_s": events.get("KSPSolve"),
           "launches": {k: v for k, v in launches.items() if v}, "launches_needed": need,
           "v1_kernel_per_level": v1,
           "peak_mem_MiB": torch.cuda.max_memory_allocated() / 2 ** 20}
    prof = None
    if profile:
        xv = A.createVecRight()
        warm = warm_ms(ksp, b, xv)
        check_ex45(ksp, A_sp, b_np, xv, pc)
        q1_levels = [lev.A.meta[1] for lev in levels[:-1] if lev.P.meta[0] == "interp_q1"]
        prof = profile_solve(ksp, b, xv, warm, q1_levels)
        check_ex45(ksp, A_sp, b_np, xv, pc)
        rec.update(warm_ms_best_of_3=warm, ms_per_it=warm / chk["its"],
                   device_busy_ms=prof["device_busy_ms"], busy_share=prof["busy_share_of_warm"],
                   device_events=prof["device_events"])
    return rec, launches, prof, A


def ex45_v1_row(A, flush):
    """V1 on ex45's level-0 operator as its binder planned it (129^3, the 7
    planes of the star; the odd n2 takes the window kernel's scalar
    variant) against its plain version in f64 (equal bits), timed after
    the clean flush beside the plain version and its bound (the planes, x
    and y moved once)."""
    import torch
    from petsc_tpu_torch.ops import grid_kernels as gridk
    shape, offs = A.meta[1], A.meta[2]
    coef = A.device_data()["coef"]
    mult = A.op().mult
    n = math.prod(shape)
    x = torch.rand(n, generator=torch.Generator(device="cuda").manual_seed(7), device="cuda",
                   dtype=coef.dtype)
    cvals = (None,) * len(offs)
    r = grid_kernel_row("dnd_stencil", coef.dtype, lambda: mult(x),
                        lambda: gridk.dnd_stencil_plain(x, shape, offs, cvals, coef), None,
                        (len(offs) + 2) * n * coef.element_size(), 2 * len(offs) * n,
                        TOL[str(coef.dtype).replace("torch.", "")], shape=list(shape),
                        planes=len(offs), kernel=mult.kernel,
                        variant="vector" if mult.window["vector"] else "scalar",
                        block=list(mult.window["block"]), grid=list(mult.window["grid"]),
                        library="none: no single PyTorch call applies per-point coefficient "
                                "planes")
    if not r["equal_bits"]:
        raise AssertionError("V1 on ex45's level 0 differs from its plain version in bits")
    fn, plain = r.pop("_fn"), r.pop("_plain")
    for k in ("_library", "_earlier"):
        r.pop(k)
    r["ms"] = time_ms(fn, flush)
    r["plain_ms"] = time_ms(plain, flush)
    r["library_ms"] = None
    r["share_of_bound"] = r["bound_ms"] / r["ms"]
    return r


def ex45_dof3_case(pt):
    """dof 3 on a 65^3 DMDA (823,875 rows, ex56 ne 64's scale): ex45's
    operator for each component (ex45.component_laplacian) assembled by
    COO into da.createMatrix() (kind aij_bsr, B1), KSP.setOperators with no
    callback, so that PCMG from the DM takes Galerkin coarse operators
    through kron(P, I_3) (Q1P/Q1R at dof 3), b = 1, CG to rtol 1e-8; the
    launches as ex45_launches_needed counts them, the contract of
    `python ex45_contract.py 65 dof3`, and the warm solve."""
    import torch
    from petsc_tpu_torch.examples import ex45
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    pt.init(args=EX45_ARGS + ["-pc_type", "mg"])
    pt.log().reset()
    da = pt.DMDA.create(3, (EX45_DOF3_N,) * 3, dof=3, stencil_width=1)
    A = da.createMatrix()
    i, j, v = ex45.component_laplacian(da)
    t1 = time.perf_counter()
    A.setPreallocationCOO(i, j)
    A.setValuesCOO(v)
    torch.cuda.synchronize()
    coo_s = time.perf_counter() - t1
    del i, j, v
    ksp = pt.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    b = A.createVecLeft()
    b.set(1.0)
    x = A.createVecRight()
    ksp.solve(b, x)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = launch_counts()
    events = set_up_events(pt)
    A_sp = A.to_scipy()
    b_np = b.array.double().cpu().numpy()
    chk = check_ex45(ksp, A_sp, b_np, x, "dof3")
    levels = ksp.getPC()._impl.levels
    need = ex45_launches_needed(chk["its"], levels, "dof3")
    bad = {k: (launches[k], v) for k, v in need.items() if launches[k] != v}
    if bad:
        raise AssertionError(f"ex45 dof3: launches (got, want): {bad}")
    warm = warm_ms(ksp, b, x)
    check_ex45(ksp, A_sp, b_np, x, "dof3")
    return {"n": EX45_DOF3_N, "dof": 3, **chk, "coo_assembly_s": coo_s,
            "first_solve_s_incl_init_and_setup": first_s, "setup_events_s": events,
            "launches": {k: v for k, v in launches.items() if v}, "launches_needed": need,
            "warm_ms_best_of_3": warm, "ms_per_it": warm / chk["its"]}, launches


def q1_dof_rows(gridk, flush):
    """Q1P and Q1R at dof 2 on a 2-D grid (1025^2 <- 513^2) and dof 3 on a
    3-D one (65^3 <- 33^3, the dof-3 solve's finest transfer), f64 and f32,
    each against its plain version (1e-12 relative in f64, 1e-5 in f32;
    equal bits reported), timed after the clean flush beside the plain
    version, its bound (the fine and the coarse vector moved once) and the
    library call (F.interpolate, bilinear or trilinear with align_corners,
    and the depthwise F.conv2d/conv3d of stride 2 with the [.5, 1, .5]
    weights, on the components as channels in channels-last layout, which
    is the DMDA's)."""
    import torch
    import torch.nn.functional as F
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(45)
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for dtype in (torch.float64, torch.float32):
        isz = torch.empty((), dtype=dtype).element_size()
        for fshape, dof in (((1025, 1025), 2), ((EX45_DOF3_N,) * 3, 3)):
            cshape = tuple((s + 1) // 2 for s in fshape)
            nf, nc = math.prod(fshape) * dof, math.prod(cshape) * dof
            xc = torch.rand(nc, generator=gen, device=dev, dtype=dtype)
            xf = torch.rand(nf, generator=gen, device=dev, dtype=dtype)
            nd = len(fshape)
            last = (0, nd + 1) + tuple(range(1, nd + 1))     # (1, *grid, dof) -> (1, dof, *grid)
            back = (0,) + tuple(range(2, nd + 2)) + (1,)
            xc_cl = xc.view((1,) + cshape + (dof,)).permute(last)
            xf_cl = xf.view((1,) + fshape + (dof,)).permute(last)
            h = torch.tensor([0.5, 1.0, 0.5], dtype=dtype, device=dev)
            w = h
            for _ in range(nd - 1):
                w = w[..., None] * h
            w = w.expand((dof, 1) + (3,) * nd).contiguous()
            conv = F.conv3d if nd == 3 else F.conv2d
            mode = "trilinear" if nd == 3 else "bilinear"
            lib_p = lambda xc_cl=xc_cl, fshape=fshape, mode=mode: F.interpolate(  # noqa: E731
                xc_cl, size=fshape, mode=mode, align_corners=True)
            lib_r = lambda xf_cl=xf_cl, w=w, conv=conv, dof=dof: conv(  # noqa: E731
                xf_cl, w, stride=2, padding=1, groups=dof)
            for name, fn, plain, lib, lib_name in (
                    ("q1_prolong", lambda xc=xc, fshape=fshape, dof=dof:
                        gridk.q1_prolong(xc, fshape, dof),
                     lambda xc=xc, fshape=fshape, dof=dof: gridk.q1_prolong_plain(xc, fshape, dof),
                     lib_p, f"F.interpolate({mode}, align_corners=True), channels last"),
                    ("q1_restrict", lambda xf=xf, fshape=fshape, dof=dof:
                        gridk.q1_restrict(xf, fshape, dof),
                     lambda xf=xf, fshape=fshape, dof=dof: gridk.q1_restrict_plain(xf, fshape, dof),
                     lib_r, f"F.conv{nd}d(stride 2, padding 1, groups {dof}, [.5, 1, .5]^{nd}), "
                            "channels last")):
                r = grid_kernel_row(name, dtype, fn, plain, lib, (nf + nc) * isz, 2 * nf,
                                    TOL[str(dtype).replace("torch.", "")], fine=list(fshape),
                                    dof=dof, library=lib_name)
                r["library_rel_err"] = rel_err(lib().permute(back).reshape(-1), plain())
                rows.append(r)
    gridk.reset_launches()
    for r in rows:
        fn, plain, lib = r.pop("_fn"), r.pop("_plain"), r.pop("_library")
        r.pop("_earlier")
        r["ms"] = time_ms(fn, flush)
        r["plain_ms"] = time_ms(plain, flush)
        r["library_ms"] = time_ms(lib, flush)
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
    return rows


def tutorial_step(pt):
    """The port's ex2 (GMRES + ILU, -ksp_monitor, its default 8 x 7 grid) and
    ex1 (-ksp_view) on the card, each one's printed text held to the same
    run's under init(device="cpu") by the port's diff_output (numbers to
    1e-6 relative: the card sums in another order)."""
    from petsc_tpu_torch.examples import ex1, ex2
    from petsc_tpu_torch.utils.testing import diff_output, run_example
    out = {}
    for name, main, args in (("ex2", ex2.main, ["-ksp_monitor"]),
                             ("ex1", ex1.main, ["-ksp_view"])):
        card = run_example(main, args)
        host = run_example(main, args, device="cpu")
        problems = diff_output(card, host, rtol=1e-6, atol=1e-12)
        if problems:
            raise AssertionError(f"{name} {args}: the card's text differs from the CPU's:\n"
                                 + "\n".join(problems) + "\n--- card ---\n" + card)
        out[name] = {"args": args, "lines": len(card.splitlines()), "equal_text": card == host,
                     "last_line": card.strip().splitlines()[-1]}
    pt.init()     # back on the card
    return out


def phase_ex45(pt, gridk, smi, t_start, flush):
    """PETSc's ex45 on the card at 129^3 (2,146,689 rows): CG with PCMG from
    the DM (7 rediscretized aij_dnd levels, Q1P/Q1R) and CG with GAMG (the
    structured device head on the DM's grid, then the host aggregation
    tail), each against the reference's contract with exact launches, timed
    warm and profiled; the host seconds of node_coords and interior_mask at
    129^3; V1 on the level-0 operator; the dof-3 PCMG solve at 65^3 with
    Galerkin coarse operators; Q1P/Q1R's dof rows; the tutorials on the
    card against the CPU. Returns
    (the record, the Q1 dof rows, launches and profiles by case)."""
    import torch
    t0 = time.perf_counter()
    out = {"phase": "ex45", "nvidia_smi": smi, "args": EX45_ARGS, "n": EX45_N}
    pt.init(args=[])
    da = pt.DMDA.create(3, (EX45_N,) * 3)
    for name in ("node_coords", "interior_mask"):
        t1 = time.perf_counter()
        getattr(da, name)()
        out[f"{name}_s"] = time.perf_counter() - t1
    launches, profs = {}, {}
    for pc in ("mg", "gamg"):
        rec, launches[pc], profs[pc], A = ex45_case(pt, pc)
        out[pc] = rec
        out[f"{pc}_profile"] = profs[pc]
        if pc == "mg":
            out["v1_level0"] = ex45_v1_row(A, flush)
        del A
        torch.cuda.empty_cache()
    out["dof3"], launches["dof3"] = ex45_dof3_case(pt)
    torch.cuda.empty_cache()
    dof_rows = q1_dof_rows(gridk, flush)
    out["q1_dof_checks"] = dof_rows
    out["tutorials"] = tutorial_step(pt)
    out["seconds"] = time.perf_counter() - t0
    out["seconds_so_far"] = time.perf_counter() - t_start
    return out, dof_rows, launches, profs


# bench_gpu.py's contract: BENCH_r05.json's solve (the JAX package on the TPU)
BENCH_SOLVE_ITS = 10
BENCH_JACOBI_ITS = 184


def phase_bench_gpu(smi, t_start):
    """python bench_gpu.py as a subprocess on the card: its line, and its
    contract (solve its 10, relres <= 1e-8, jacobi_its 184, the small-n
    check passed, quality measured, pct_stencil_roofline <= 100)."""
    t0 = time.perf_counter()
    here = Path(__file__).resolve().parent
    r = subprocess.run([sys.executable, str(here / "bench_gpu.py")], cwd=here,
                       capture_output=True, text=True, timeout=900)
    lines = r.stdout.strip().splitlines()
    if r.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"bench_gpu.py exited {r.returncode} with {len(lines)} lines; "
                             f"stderr: {r.stderr[-3000:]}")
    line = json.loads(lines[0])
    s = line["solve"]
    fails = [k for k, ok in (
        ("its", s["its"] == BENCH_SOLVE_ITS), ("relres", s["relres"] <= 1e-8),
        ("jacobi_its", s["jacobi_its"] == BENCH_JACOBI_ITS),
        ("small_n_check", line["small_n_check"]["passed"]),
        ("quality", line["quality"] == line["varcoef_quality"] == s["quality"] == "measured"),
        ("pct_stencil_roofline", line["pct_stencil_roofline"] <= 100.0)) if not ok]
    rec = {"phase": "bench_gpu", "nvidia_smi": smi, "seconds": time.perf_counter() - t0,
           "seconds_so_far": time.perf_counter() - t_start, "line": line}
    emit(rec)
    if fails:
        raise AssertionError(f"bench_gpu.py broke its contract on {fails}")
    return line


# ---------------------------------------------------------------------
# ROADMAP item 7's card paths: MatShell, MatDense (matSolve), MatSBAIJ,
# MatMAIJ and MatKAIJ (M1)
# ---------------------------------------------------------------------

# `python mat7_contract.py 128 maij|kaij|matsolve`: the JAX package's run of
# the maij_kaij and mat_shell_dense solves on the CPU (JAX 0.9.0, x64): its,
# reason, the residual history and the true relative residual
MAT7_CONTRACT = {
    "maij":
        {"its": 205, "reason": "CONVERGED_RTOL", "true_relres": 9.419034255304139e-09,
         "history": (
             2048.0, 1984.0760441725827, 8324.105892863501, 6158.630311383686,
             5842.825540088709, 6322.58404482812, 5708.758563450306, 5681.617163373634,
             5571.270987155918, 5320.275260107101, 5252.572374951695, 5041.624759740303,
             4911.88123063736, 4781.163583167877, 4602.691906830944, 4501.1878365273515,
             4324.639767827493, 4215.972540637948, 4074.8053010450926, 3934.4403392022173,
             3829.0864247829854, 3674.81084893084, 3582.222317069271, 3438.7050848928207,
             3331.0189204041917, 3216.6675298099976, 3090.8731709175636, 2999.4054837406034,
             2867.553371430277, 2780.8169056423717, 2662.4164441328626, 2565.650539734243,
             2468.425177891105, 2359.3421854500148, 2278.5515311810673, 2167.950140791154,
             2089.739673773997, 1989.8327225566018, 1904.3932993667663, 1820.9955309864533,
             1727.8790187052286, 1656.238453124706, 1562.992288950964, 1493.6341654989772,
             1409.3928091908733, 1334.9074909505446, 1263.1050295768703, 1183.6848884685812,
             1120.4354107701308, 1042.017632191351, 980.064670350452, 908.8603629122925,
             843.6285105026817, 781.3169502831909, 713.5096838698546, 656.6356849568683,
             590.5424841874878, 534.1795713172718, 473.2770039869761, 415.11563560097187,
             359.2451155753999, 300.4113247468028, 246.7067957828393, 189.33921608045537,
             134.9510387827135, 130.56413000582938, 181.46480731272243, 205.2250396185356,
             159.40309662849575, 132.95153175850353, 129.54429002969164, 116.628864728018,
             105.77094455306585, 94.56900207082309, 87.54439556514983, 78.08215907693425,
             70.43830602822666, 64.09690184592667, 57.272508414700546, 51.85395733244499,
             46.78198399233559, 42.349251077384174, 37.87962780510515, 34.48391842898708,
             31.205523527987733, 28.323460385576585, 25.894520397673784, 23.525144078399883,
             21.727569945436972, 19.708250179674977, 18.054932877875174, 16.267276023031837,
             14.496921598360325, 12.873108452929674, 11.253524387514252, 10.076188322647031,
             8.920536254484487, 7.9690905466090225, 7.008960307263225, 6.138609541703026,
             5.435484218087322, 4.71993513949605, 4.154053559152414, 3.5850061857314848,
             3.120644547255563, 2.6943024140291474, 2.305584418815132, 1.9889570685025326,
             1.6775827713528013, 1.435410324238521, 1.2034089346144328, 1.0134444789112493,
             0.8492007322936451, 0.7020524439459827, 0.5882149122883238, 0.4821511104813815,
             0.4015331209105385, 0.3316928060128065, 0.27574379297407997, 0.23290681225788354,
             0.19726287785678712, 0.17205774767191168, 0.15021366458215515,
             0.13452229410786698, 0.1190087268868623, 0.10277089374198023, 0.0870725345535941,
             0.06988157948215479, 0.054480857582220175, 0.04733530648768199,
             0.04943847390861938, 0.04387059384796166, 0.036629921501683614,
             0.03318775870037033, 0.029092020988900888, 0.025112506048430783,
             0.021605904261302475, 0.018584498030112816, 0.01498441886491926,
             0.013452237391987944, 0.010818468753284, 0.009507338553758902,
             0.008067242252398098, 0.007104304584163782, 0.005632782148771388,
             0.004667766352898343, 0.003828798303455683, 0.003089388564400103,
             0.002668249840907254, 0.0022110023606347145, 0.0018134921286984407,
             0.0015290090999557702, 0.0012526154352254805, 0.0010355896112460745,
             0.0008408016751766166, 0.0006844990506851724, 0.0005773797683978064,
             0.0004916127391034988, 0.00041900009910300943, 0.00036245760266656433,
             0.0003196595906896961, 0.0002933655382427386, 0.00027427986351549207,
             0.00027043755451879666, 0.00027568309035362945, 0.0002868055891692529,
             0.00030493029493689, 0.00032814209866695635, 0.00035586179115178,
             0.0003732049978655617, 0.00038313230108821225, 0.00038417836877899334,
             0.00037666205938809437, 0.0003579154611037853, 0.00033183910475531955,
             0.00030949633522999674, 0.00028882124791192296, 0.00027077212475351976,
             0.0002521857412741991, 0.00023460324631114965, 0.00021658669689291417,
             0.00019345601423783208, 0.00016741964282872108, 0.0001406532414456408,
             0.00011742902154117469, 9.992655681677637e-05, 8.707449299610162e-05,
             7.931314062410324e-05, 7.57467629236304e-05, 7.530159696252703e-05,
             7.589178597135753e-05, 7.24326579424716e-05, 6.99348720613217e-05,
             7.086409957793976e-05, 7.283681780072272e-05, 6.354396694550259e-05,
             5.4751615926815225e-05, 4.731007925052623e-05, 4.039096954237928e-05,
             3.6073869513270696e-05, 3.331689786066158e-05, 3.071335789590893e-05,
             2.8232671698754692e-05, 2.452569929564169e-05, 2.1038480245285113e-05,
             1.9290181392516625e-05,)},
    "kaij":
        {"its": 6, "reason": "CONVERGED_RTOL", "true_relres": 1.2679360441833712e-09,
         "history": (
             2508.277496609974, 33.38799509739107, 1.3562276647146707, 0.04036191784210581,
             0.0010087362459093902, 3.3847743181674664e-05, 3.1803354297226957e-06,)},
    "matsolve": (
        {"its": 10, "reason": "CONVERGED_RTOL", "true_relres": 3.4892518396667014e-07,
         "history": (
             46860.812329914144, 7488.182148857781, 1096.8634550591057, 111.47676981915953,
             22.57428172919544, 3.359027910593749, 0.31652433151342046, 0.05881924956690744,
             0.010350121999600875, 0.0011633350764347042, 0.00020551337644568885,)},
        {"its": 10, "reason": "CONVERGED_RTOL", "true_relres": 5.769031498147653e-10,
         "history": (
             70.60142826840877, 4.072223963240827, 0.1253446503006587, 0.013192429173115574,
             0.0027594868944700733, 0.001085617297074456, 0.000273288102871097,
             4.5207616598144175e-05, 1.0048538133942453e-05, 1.162729709426297e-06,
             2.3522077744559274e-07,)},
        {"its": 10, "reason": "CONVERGED_RTOL", "true_relres": 5.75082774855716e-10,
         "history": (
             70.60151195943358, 4.072212605525569, 0.12535741416811105, 0.01318962254538879,
             0.0027575768966439807, 0.0010854889774158652, 0.00027371478996853453,
             4.49787698654898e-05, 1.0010781521905548e-05, 1.1593881209349045e-06,
             2.3388606355454114e-07,)},
        {"its": 10, "reason": "CONVERGED_RTOL", "true_relres": 5.733418275444831e-10,
         "history": (
             70.60159504720414, 4.072202025598277, 0.12537031701001286, 0.01318676439133009,
             0.0027555468683982784, 0.0010852889183831243, 0.0002741365553711851,
             4.474793010370889e-05, 9.972121111010659e-06, 1.1562036390917102e-06,
             2.325495275278772e-07,)},
    ),
}
MAT7_HIST_TOL = 1e-6        # the contract's histories, as every other path's
SHELL_HIST_TOL = 1e-12      # the three operators' CG+Jacobi histories against (a)'s


def hist_rel(h, want):
    """max |h - want| / |want| entrywise; inf where the lengths differ."""
    import numpy as np
    h, w = np.asarray(h, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(h - w) / np.abs(w))) if h.shape == w.shape else math.inf


def cg_launches_needed(its, product):
    """The launches of init and one CG solve from x0 = 0 with PC none or
    jacobi (whose apply is a PyTorch product): K1 once in init; per
    iteration one product, two K2, one K3 and two K4, and one K4 before
    them; nothing else of the port's kernels."""
    return {"probe": 1, product: its, "triad": 2 * its, "axpy_normsq": its,
            "dot2": 1 + 2 * its}


def exact_launches(label, launches, need):
    """Every kernel's count equal to need's (0 where need names none)."""
    bad = {k: (v, need.get(k, 0)) for k, v in launches.items() if v != need.get(k, 0)}
    if bad:
        raise AssertionError(f"{label}: launches (got, want): {bad}")


def box27_stencil_coeffs(n):
    """The box27 operator as Mat.createStencil's arguments: the 27 offsets
    (dz, dy, dx) in product order and one coefficient plane each (26 on the
    centre, -1 elsewhere; couplings that leave the grid are not stored)."""
    import itertools
    import numpy as np
    offs = list(itertools.product((-1, 0, 1), repeat=3))
    coeffs = np.full((len(offs),) + (n,) * 3, -1.0)
    coeffs[offs.index((0, 0, 0))] = 26.0
    return offs, coeffs


def jacobi_on(pt, pk, make_op, label):
    """CG+Jacobi at 128^3 to rtol 1e-8 (b = 1, x0 = 0) on the operator
    make_op() builds after init, every launch count set to 0 just before
    init and read just after the solve; checked as the main solve (184
    iterations, CONVERGED_RTOL, relres and the true residual). Returns
    (the record, ksp, A, b, x, launches)."""
    import torch
    torch.cuda.synchronize()
    reset_launches()
    pt.init(args=["-ksp_type", "cg", "-pc_type", "jacobi", "-ksp_rtol", "1e-8",
                  "-ksp_max_it", "3000"])
    t0 = time.perf_counter()
    A = make_op()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ksp = pt.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    b = A.createVecLeft()
    b.set(1.0)
    x = A.createVecRight()
    t0 = time.perf_counter()
    ksp.solve(b, x)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = launch_counts()
    its, reason, relres, true_rel = check_solve(pk, ksp, b, x)
    rec = {"operator": label, "kind": A.meta[0], "its": its, "reason": reason,
           "relres": relres, "true_relres": true_rel, "build_s": build_s,
           "first_solve_s": solve_s, "launches": {k: v for k, v in launches.items() if v}}
    return rec, ksp, A, b, x, launches


def phase_mat_shell_dense(pt, pk, sb, smi, t_start):
    """MatShell, Mat.createStencil and MatDense on the main path's 128^3
    box27: CG+Jacobi on (a) the stencil Mat, (b) a Mat.createShell whose
    mult is (a)'s operator and whose diag is (a)'s diagonal, (c)
    Mat.createStencil((128,)*3, box27 offsets, coefficient planes) (kind
    aij_dnd, V1's window kernel), each against the main solve's contract
    with exact launches and a history equal to (a)'s to 1e-12, timed warm
    and (b), (c) profiled; then KSP.matSolve with CG + GAMG's structured
    head (f64 cycle) on a MatDense B of four columns (matsolve_rhs): a
    MatDense back, each column equal to ksp.solve of that column (1e-12)
    and to the contract of `python mat7_contract.py 128 matsolve` (its,
    reason, history to 1e-6; column 0 GAMG_GRID_ITS), the launches exact
    (the set-up once, then each column's solve). Returns (the record,
    {path: launches}, {path: profile})."""
    import numpy as np
    import torch
    t_phase = time.perf_counter()
    out = {"phase": "mat_shell_dense", "nvidia_smi": smi, "n": N_MAIN, "stencil": "box27",
           "rtol": 1e-8}
    launches, profs = {}, {}

    def stencil():
        return sb.as_mat(*sb.build_dnd((N_MAIN,) * 3, kind="box"))

    ra, ksp_a, A, b, x, la = jacobi_on(pt, pk, stencil, "stencil Mat (build_dnd + as_mat)")
    hist_a = ksp_a.getConvergenceHistory()
    exact_launches("mat_shell_dense (a)", la, cg_launches_needed(ra["its"], "const_stencil"))
    ra["warm_ms_best_of_3"] = warm_ms(ksp_a, b, x)
    check_solve(pk, ksp_a, b, x)
    out["stencil"] = ra
    op_a = A.op()

    def shell():
        return pt.Mat.createShell(A.getSize(), mult=op_a.mult, diag=op_a.diag)

    offs, coeffs = box27_stencil_coeffs(N_MAIN)
    for key, make, label, product in (
            ("shell", shell, "Mat.createShell over (a)'s mult and diagonal", "const_stencil"),
            ("create_stencil", lambda: pt.Mat.createStencil((N_MAIN,) * 3, offs, coeffs),
             "Mat.createStencil((128,)*3, box27 offsets, coefficient planes)", "dnd_stencil")):
        rec, ksp, M, bk_, xk, lk = jacobi_on(pt, pk, make, label)
        rec["history_rel_diff_vs_stencil"] = hist_rel(ksp.getConvergenceHistory(), hist_a)
        exact_launches(f"mat_shell_dense {key}", lk, cg_launches_needed(rec["its"], product))
        if key == "create_stencil":
            kern = M.op().mult.kernel
            rec["v1_kernel"] = kern
            if M.meta[0] != "aij_dnd" or len(M.meta[2]) != 27 or kern != "window":
                raise AssertionError(f"createStencil at 128^3: kind {M.meta[0]}, "
                                     f"{len(M.meta[2])} offsets, V1 kernel {kern}")
        if not rec["history_rel_diff_vs_stencil"] <= SHELL_HIST_TOL:
            raise AssertionError(f"mat_shell_dense {key}: history differs from the stencil "
                                 f"Mat's by {rec['history_rel_diff_vs_stencil']}")
        rec["warm_ms_best_of_3"] = warm_ms(ksp, bk_, xk)
        prof = profile_solve(ksp, bk_, xk, rec["warm_ms_best_of_3"])
        check_solve(pk, ksp, bk_, xk)
        rec.update(device_busy_ms=prof["device_busy_ms"], busy_share=prof["busy_share_of_warm"],
                   device_events=prof["device_events"])
        out[key], launches[key], profs[key] = rec, lk, prof
        del ksp, M, bk_, xk
    del coeffs, ksp_a, A, b, x, op_a
    torch.cuda.empty_cache()

    # KSP.matSolve on the main path (CG + GAMG's structured head, f64 cycle)
    N = N_MAIN ** 3
    Bnp = matsolve_rhs(N)
    k = Bnp.shape[1]
    torch.cuda.synchronize()
    reset_launches()
    pt.init(args=["-ksp_type", "cg", "-pc_type", "gamg", "-ksp_rtol", "1e-8",
                  "-ksp_max_it", "60"])
    A = stencil()
    ksp = pt.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    B = pt.Mat.createDense((N, k), array=Bnp)
    t0 = time.perf_counter()
    X = ksp.matSolve(B)
    torch.cuda.synchronize()
    ms_s = time.perf_counter() - t0
    lm = launch_counts()
    its_all, reason_all = ksp.getIterationNumber(), ksp.getConvergedReason().name
    if type(X).__name__ != "MatDense" or X.getSize() != (N, k):
        raise AssertionError(f"matSolve returned {type(X).__name__} {X.getSize()}")
    Xa = X.getDenseArray()
    levels = ksp.getPC()._impl.levels
    need, cols = {}, []
    for c in range(k):
        bc = pt.Vec.from_array(Bnp[:, c])
        xc = A.createVecRight()
        ksp.solve(bc, xc)
        its_c, reason_c = ksp.getIterationNumber(), ksp.getConvergedReason().name
        want = MAT7_CONTRACT["matsolve"][c]
        xs = xc.array
        diff = float(np.max(np.abs(Xa[:, c] - xs.cpu().numpy())) / float(xs.abs().max()))
        Ax = pk.const_stencil_plain(xs, (N_MAIN,) * 3, 26.0, -1.0, True)
        true_rel = float(torch.linalg.vector_norm(bc.array - Ax)
                         / torch.linalg.vector_norm(bc.array))
        col = {"column": c, "its": its_c, "reason": reason_c,
               "history_rel_diff_vs_reference": hist_rel(ksp.getConvergenceHistory(),
                                                         want["history"]),
               "true_relres": true_rel, "reference_true_relres": want["true_relres"],
               "max_rel_diff_vs_matsolve": diff}
        cols.append(col)
        if (its_c != want["its"] or reason_c != want["reason"]
                or not col["history_rel_diff_vs_reference"] <= MAT7_HIST_TOL
                or not diff <= SURFACE_RED_RTOL or not true_rel <= 10 * want["true_relres"]
                or (c == 0 and its_c != GAMG_GRID_ITS)):
            raise AssertionError(f"matSolve column {c}: {col} (want {want['its']} its)")
        for kk, v in grid_launches_needed(its_c, levels, probes=27 if c == 0 else 0,
                                          lanczos=10 if c == 0 else 0).items():
            need[kk] = need.get(kk, 0) + v
    need["probe"] = 1
    exact_launches("matSolve", lm, need)
    if its_all != max(cl["its"] for cl in cols) or reason_all != "CONVERGED_RTOL":
        raise AssertionError(f"matSolve: its {its_all}, {reason_all}; columns {cols}")
    t0 = time.perf_counter()
    ksp.matSolve(B, X)
    torch.cuda.synchronize()
    out["matsolve"] = {"k": k, "B": "MatDense (2097152, 4), 67 MB", "returns": "MatDense",
                       "its": its_all, "reason": reason_all, "columns": cols,
                       "first_matsolve_s_incl_setup": ms_s,
                       "warm_matsolve_s": time.perf_counter() - t0,
                       "launches": {kk: v for kk, v in lm.items() if v}}
    launches["matsolve"] = lm
    del ksp, A, B, X, Xa
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    out["seconds_so_far"] = time.perf_counter() - t_start
    return out, launches, profs


def phase_sbaij(pt, ne64, smi, t_start):
    """PETSc's ex56 at ne 64 with its operator built as MatSBAIJ.from_scipy
    of the CSR that phase ex56 assembled (no second element assembly): the
    upper triangle on the host, the expanded CSR on the card as kind
    aij_csr (bs gives no block size) until setBlockSize(3) (aij_bsr);
    the expanded CSR is the upper triangle's nonzeros mirrored (the
    assembly's explicit zeros dropped, as in the reference), within 1e-15
    of the assembled matrix, and the BSR its blocks (no more than phase
    ex56's); then the
    rigid-body modes and CG + GAMG at the defaults (rtol 1e-4), every
    launch count set to 0 just before from_scipy and read just after the
    solve, against phase ex56's contract (EX56_CONTRACT: its, history,
    hierarchy, aggregates' hash), its history against phase ex56's run
    and its launches exact (ex56_launches_needed); warm and profiled.
    Returns (the record, launches, profile)."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    A_asm, b_np, coords, hist_ex56, nblocks = ne64
    t_phase = time.perf_counter()
    pt.init(args=["-ne", "64"] + EX56_DEFAULTS)
    torch.cuda.synchronize()
    reset_launches()
    pt.log().reset()
    secs = {}
    t0 = time.perf_counter()
    S = pt.MatSBAIJ.from_scipy(A_asm, bs=3)
    torch.cuda.synchronize()
    secs["from_scipy_s"] = time.perf_counter() - t0
    if S.meta[0] != "aij_csr" or S.getBlockSize() != 1 or S._bs_sym != 3:
        raise AssertionError(f"MatSBAIJ.from_scipy(bs=3): kind {S.meta[0]}, block size "
                             f"{S.getBlockSize()} (the reference's bs sets none)")
    t0 = time.perf_counter()
    U = sp.triu(A_asm).tocsr()
    U.eliminate_zeros()
    want = (U + sp.triu(U, 1).T).tocsr()
    F = S.to_scipy()
    ip, ix, v = S.upper_csr()
    expanded = {"nnz": int(F.nnz), "assembled_nnz": int(A_asm.nnz),
                "assembled_explicit_zeros": int((A_asm.data == 0).sum()),
                "upper_nnz": int(len(v)),
                "equal_to_the_upper_mirror": bool((F != want).nnz == 0),
                "max_abs_diff_vs_assembled": float(abs(F - A_asm).max()),
                "max_abs_assembled": float(abs(A_asm).max())}
    secs["host_checks_s"] = time.perf_counter() - t0
    del U, want, F
    if not (expanded["equal_to_the_upper_mirror"]
            and expanded["max_abs_diff_vs_assembled"] <= 1e-15 * expanded["max_abs_assembled"]):
        raise AssertionError(f"sbaij: the expanded CSR {expanded}")
    t0 = time.perf_counter()
    S.setBlockSize(3)
    torch.cuda.synchronize()
    secs["setBlockSize_s"] = time.perf_counter() - t0
    # the assembly's explicit zeros fill whole 3 x 3 blocks at the bottom
    # face's decoupled dofs: the expanded CSR drops them, and so its BSR
    expanded.update(blocks=S.device_data()["bcol"].numel(), ex56_blocks=nblocks)
    if S.meta[0] != "aij_bsr" or not 0 < expanded["blocks"] <= nblocks:
        raise AssertionError(f"sbaij after setBlockSize(3): kind {S.meta[0]}, "
                             f"{expanded['blocks']} blocks (phase ex56: {nblocks})")
    S.setNearNullSpace(pt.MatNullSpace.createRigidBody(coords))
    ksp = pt.KSP().create()
    ksp.setOperators(S)
    ksp.setNormType("unpreconditioned")
    ksp.setTolerances(rtol=EX56_RTOL, max_it=200)
    ksp.setFromOptions()
    b = pt.Vec.from_array(b_np)
    x = S.createVecRight()
    t0 = time.perf_counter()
    ksp.setUp()
    torch.cuda.synchronize()
    secs["setup_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ksp.solve(b, x)
    torch.cuda.synchronize()
    secs["first_solve_s"] = time.perf_counter() - t0
    launches = launch_counts()
    chk = check_ex56(ksp, A_asm, b_np, x, (64, "defaults"))
    nlev = len(ksp.getPC()._impl.levels)
    exact, _ = ex56_launches_needed(chk["its"], nlev, False)
    exact_launches("sbaij", {k: launches[k] for k in exact}, exact)
    if launches["csr_spmm"]:
        raise AssertionError(f"sbaij: {launches['csr_spmm']} M1 launches")
    rec = {"phase": "sbaij", "nvidia_smi": smi, "ne": 64, "unknowns": A_asm.shape[0],
           "rtol": EX56_RTOL, **secs, "expanded_csr": expanded, **chk,
           "history_rel_diff_vs_phase_ex56": hist_rel(ksp.getConvergenceHistory(), hist_ex56),
           "launches": {k: v for k, v in launches.items() if v}, "launches_exact": exact}
    if not rec["history_rel_diff_vs_phase_ex56"] <= MAT7_HIST_TOL:
        raise AssertionError(f"sbaij: history against phase ex56's "
                             f"{rec['history_rel_diff_vs_phase_ex56']}")
    warm = warm_ms(ksp, b, x)
    check_ex56(ksp, A_asm, b_np, x, (64, "defaults"))
    prof = profile_solve(ksp, b, x, warm)
    check_ex56(ksp, A_asm, b_np, x, (64, "defaults"))
    rec.update(warm_ms_best_of_3=warm, device_busy_ms=prof["device_busy_ms"],
               busy_share=prof["busy_share_of_warm"], device_events=prof["device_events"],
               seconds=time.perf_counter() - t_phase,
               seconds_so_far=time.perf_counter() - t_start)
    del ksp, S, b, x
    torch.cuda.empty_cache()
    return rec, launches, prof


def spmm_bytes(m, n, nnz, k, itemsize):
    """M1's bytes: vals and col once, indptr once, X read and Y written once."""
    return nnz * (itemsize + 4) + (m + 1) * 8 + (n + m) * k * itemsize


def m1_chunk(k, itemsize):
    """M1's entries per chunk for a tile of k columns of `itemsize`-byte
    values (at k = 1 S2's tile, csr_tile: M1 on one column is S2's product;
    else kChunkBytes / itemsize in csr_spmm.cu; a wider X is tiled by 8
    columns, so its first tile's)."""
    import re
    if k == 1:
        return csr_tile()
    src = (Path(__file__).resolve().parent / "petsc_tpu_torch" / "csrc" / "csr_spmm.cu").read_text()
    return int(re.search(r"constexpr int kChunkBytes = (\d+);", src).group(1)) // itemsize


M1_EDGE_KS = (1, 2, 3, 4, 5, 8, 9, 16)


def m1_edge_cases(k, itemsize):
    """M1's edge cases for k columns of `itemsize`-byte values: S2's
    tile-edge cases (tile_edge_cases) cut at M1's chunk (m1_chunk: rows of
    C - 1, C and C + 1 entries across
    chunk edges, a row of 50 C, runs of empty rows, entries that end on a
    chunk edge before empty rows, 5000 empty rows), a random CSR with
    about 7 entries a row, one row of 100 and empty rows, and m = 0."""
    cases = tile_edge_cases(m1_chunk(k, itemsize))
    rng = __import__("numpy").random.default_rng(k)
    lengths = [int(v) for v in rng.poisson(7, 3001)]
    lengths[1], lengths[2], lengths[-1] = 100, 0, 0
    cases["random_3001_rows"] = (lengths, -0.5)
    cases["no_rows"] = ([], -0.5)
    return cases


def m1_edge_operands(lengths, low, k, dtype, device, seed=11, n=3000):
    """(indptr, col, vals, X) on `device` for rows of the given lengths:
    uniform columns in [0, n), values uniform in [low, low + 1), X (n, k)
    uniform in [0, 1), all from `seed`."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    indptr = np.r_[0, np.cumsum(lengths, dtype=np.int64)].astype(np.int64)
    nnz = int(indptr[-1])
    return (torch.as_tensor(indptr, device=device),
            torch.as_tensor(rng.integers(0, n, nnz).astype(np.int32), device=device),
            torch.as_tensor(rng.random(nnz) + low, dtype=dtype, device=device),
            torch.as_tensor(rng.random((n, k)), dtype=dtype, device=device))


def past_an_edge(t):
    """A copy of the 1-D tensor t that starts one element past a 16-byte
    edge (a view of a longer buffer)."""
    import torch
    return torch.cat([t[:1], t])[1:] if t.numel() else t


def shifted_block(X, s):
    """A copy of the contiguous block X, a view that starts s elements past
    the start of a longer buffer (so one element past a 16-byte edge at
    s = 1, and on an 8-byte edge that is no 16-byte edge at s = 2 in f32)."""
    import torch
    flat = X.reshape(-1)
    return torch.cat([flat[:s], flat])[s:].view(X.shape)


def m1_edge_check(pk, name, k, dtype, device="cuda"):
    """M1 on one edge case (m1_edge_cases(k, itemsize)[name]) against its plain
    version run in float64 on the same inputs (f64 1e-12, f32 1e-5
    relative), for equal bits on a rerun and with vals and col one element
    past a 16-byte edge, and one launch per tile of 8 columns. Also with X
    one element past a 16-byte edge (one value a load) and, in f32, two
    (8-byte loads where 16-byte ones would serve an aligned X): each to the
    same tolerance and equal bits on its own rerun. Raises; returns the
    record."""
    import torch
    lengths, low = m1_edge_cases(k, dtype.itemsize)[name]
    ip, col, vals, X = m1_edge_operands(lengths, low, k, dtype, device)
    dn = str(dtype).replace("torch.", "")
    pk.reset_launches()
    Y = pk.csr_spmm(ip, col, vals, X)
    launches = pk.LAUNCHES["csr_spmm"]
    p = pk.csr_spmm_plain(ip, col, vals.double(), X.double())
    same = torch.equal(Y, pk.csr_spmm(ip, col, vals, X)) and \
        torch.equal(Y, pk.csr_spmm(ip, past_an_edge(col), past_an_edge(vals), X))
    shifted = [pk.csr_spmm(ip, col, vals, shifted_block(X, s))
               for s in ((1, 2) if dtype.itemsize == 4 else (1,))]
    same = same and all(torch.equal(Ys, pk.csr_spmm(ip, col, vals, shifted_block(X, s)))
                        for s, Ys in enumerate(shifted, 1))
    torch.cuda.synchronize()
    err = max(rel_err(Yo, p) if Yo.numel() and col.numel() else
              float(Yo.abs().max()) if Yo.numel() else 0.0 for Yo in [Y, *shifted])
    need = -(-k // pk.SPMM_TILE) if len(lengths) else 0
    if not err <= TOL[dn] or not same or launches != need or tuple(Y.shape) != (len(lengths), k):
        raise AssertionError(f"csr_spmm {name}, k {k}, {dn}: rel err {err} (tol {TOL[dn]}), "
                             f"equal bits on reruns {same}, launches {launches} (want {need}), "
                             f"shape {tuple(Y.shape)}")
    return {"name": f"csr_spmm_{name}", "k": k, "dtype": dn, "rows": len(lengths),
            "nnz": col.numel(), "rel_err": err, "bit_equal_rerun_and_offset": same,
            "x_offsets": [1, 2] if dtype.itemsize == 4 else [1],
            "launches": launches}


def earlier_spmm(earlier, ip, col, vals, X):
    """Y = A X by M1's earlier warp-per-row design (earlier_kernels/), one
    launch per tile of 8 columns on the current stream; raises on a CUDA
    error."""
    import torch
    from petsc_tpu_torch.ops import cuda_build
    m, k = ip.numel() - 1, X.shape[1]
    Y = torch.empty((m, k), dtype=X.dtype, device=X.device)
    fn = getattr(earlier, "ptt_earlier_csr_spmm_" + ("f64" if X.dtype == torch.float64
                                                     else "f32"))
    step = X.element_size()
    for c0 in range(0, k, 8):
        cuda_build.check("earlier csr_spmm", fn(
            Y.data_ptr() + c0 * step, ip.data_ptr(), col.data_ptr(), vals.data_ptr(),
            X.data_ptr() + c0 * step, m, k, min(8, k - c0), X.device.index or 0,
            torch.cuda.current_stream().cuda_stream))
    return Y


# M1 on the 128^3 box27 CSR: (operand, k, dtype name); the first is the
# kernel table's row, the MAIJ product
M1_CASES = (("A", 3, "float64"), ("A", 3, "float32"), ("A", 1, "float64"), ("A", 2, "float64"),
            ("A", 4, "float64"), ("A", 8, "float64"), ("A", 1, "float32"), ("A", 8, "float32"),
            ("A^T (explicit transpose)", 3, "float64"))


def m1_rows(pk, data, ncols, flush, earlier):
    """M1 against its plain version on the 128^3 box27 CSR (A's device
    arrays) and on its explicit transpose, at M1_CASES; f64 to 1e-12
    relative, f32 against the float64 product to 1e-5; equal bits on a
    rerun; the earlier warp-per-row design held to the same. Each timed
    beside its bound, the plain version and torch.sparse_csr_tensor @ X
    (cuSPARSE's SpMM), and in turns with the earlier design and k launches
    of S2 on the columns (earlier, S2 x k, M1, M1, S2 x k, earlier; ms is
    the mean of M1's two, earlier_ms and s2_per_column_ms of theirs)."""
    import numpy as np
    import torch
    from petsc_tpu_torch.mat.aij import csr_transpose_of
    ip, col, vals64 = data["indptr"], data["col"], data["vals"]
    m, nnz = ip.numel() - 1, col.numel()
    rows = []
    for which, k, dname in M1_CASES:
        dtype = getattr(torch, dname)
        if which == "A":
            cip, ccol, cvals = ip, col, vals64.to(dtype)
        else:
            cip, ccol, cvals = csr_transpose_of(data, ncols)
        X = torch.as_tensor(maij_rhs(ncols).reshape(ncols, 3)[:, [c % 3 for c in range(k)]]
                            * (1.0 + np.arange(k)), device=ip.device)
        X = X.to(dtype).contiguous()
        Y = pk.csr_spmm(cip, ccol, cvals, X)
        Y2 = pk.csr_spmm(cip, ccol, cvals, X)
        ref = pk.csr_spmm_plain(cip, ccol, cvals.double(), X.double())
        err = rel_err(Y, ref)
        e_err = rel_err(earlier_spmm(earlier, cip, ccol, cvals, X), ref)
        tol = TOL[dname]
        equal = bool(torch.equal(Y, Y2))
        if not err <= tol or not equal or tuple(Y.shape) != (m, k) or not e_err <= tol:
            raise AssertionError(f"M1 on {which}, k {k}, {dname}: rel err {err} (tol {tol}), "
                                 f"equal bits on a rerun {equal}, earlier design {e_err}")
        lib = torch.sparse_csr_tensor(cip.int(), ccol, cvals, (m, ncols))
        lib_err = rel_err(lib @ X, ref)
        cols = [X[:, c].contiguous() for c in range(k)]
        fns = {"earlier": lambda: earlier_spmm(earlier, cip, ccol, cvals, X),
               "s2": lambda: [pk.csr_spmv(cip, ccol, cvals, c) for c in cols],
               "new": lambda: pk.csr_spmm(cip, ccol, cvals, X)}
        order = ("earlier", "s2", "new", "new", "s2", "earlier")
        t = [time_ms(fns[o], flush) for o in order]
        mean = {o: statistics.mean(v for oo, v in zip(order, t) if oo == o) for o in fns}
        t_plain = time_ms(lambda: pk.csr_spmm_plain(cip, ccol, cvals, X), flush, reps=5)
        t_lib = time_ms(lambda: lib @ X, flush)
        b_ms, b_by = bound(spmm_bytes(m, ncols, nnz, k, X.element_size()), 2 * nnz * k, dname)
        ms = mean["new"]
        rows.append({"name": "csr_spmm", "operand": which, "k": k, "dtype": dname,
                     "shape": f"box27 {N_MAIN}^3 CSR, {nnz} entries, X ({ncols}, {k})",
                     "max_abs_err": float((Y.double() - ref).abs().max()), "rel_err": err,
                     "equal_bits_rerun": equal, "ms": ms, "turns": order, "turns_ms": t,
                     "earlier_ms": mean["earlier"], "earlier_rel_err": e_err,
                     "earlier": "earlier_kernels/csr_spmm_warp_per_row.cu (one warp per row)",
                     "s2_per_column_ms": mean["s2"],
                     "plain_ms": t_plain, "bound_ms": b_ms, "bound_by": b_by,
                     "share_of_bound": b_ms / ms, "earlier_share_of_bound": b_ms / mean["earlier"],
                     "library_ms": t_lib,
                     "library": "torch.sparse_csr_tensor @ X (cuSPARSE SpMM)",
                     "library_rel_err": lib_err})
        del lib, X, Y, Y2, ref
    torch.cuda.empty_cache()
    return rows


def phase_maij_kaij(pt, pk, A, smi, t_start, flush, earlier):
    """MatMAIJ and MatKAIJ on the assembled 128^3 box27 CSR A (kind
    aij_csr). (a) MatMAIJ.create(A, 3): mult (M1) and multTranspose (M1 on
    A's explicit transpose) against their plain versions (1e-12), then CG
    with -pc_type none to rtol 1e-8 on b = maij_rhs (6,291,456 unknowns);
    (b) one Radau IIA 3-stage stage system as TSIRK builds it with
    MatKAIJ, K = I (x) I_3 + A (x) (dt A_RadauIIA), dt = 0.01, its product
    against the plain one, then GMRES(30) with -pc_type none to rtol 1e-8,
    b = 1. Each solve through the user's entry points, every launch count
    set to 0 just before init and read just after the solve, against the
    contract of `python mat7_contract.py 128 maij|kaij` (its, reason,
    history to 1e-6, a true residual no worse than 10x the reference's)
    with exact launches (M1 once per product; CG's K2-K4, GMRES's K3);
    warm and profiled. Then M1's edge cases (m1_edge_check) and its rows
    (m1_rows, beside the earlier design in `earlier`). Returns (the record,
    {path: launches}, {path: profile}, M1's main row)."""
    import numpy as np
    import torch
    from petsc_tpu_torch.mat.aij import csr_transpose_of
    from petsc_tpu_torch.mat.extra_formats import MatKAIJ
    from petsc_tpu_torch.mat.utility import MatMAIJ
    from petsc_tpu_torch.ops import spmv
    t_phase = time.perf_counter()
    N = N_MAIN ** 3
    data = A.device_data()
    if A.meta[0] != "aij_csr":
        raise AssertionError(f"maij_kaij: A's kind {A.meta[0]}")
    ip, col, vals = data["indptr"], data["col"], data["vals"]
    out = {"phase": "maij_kaij", "nvidia_smi": smi, "n": N_MAIN, "stencil": "box27",
           "A": "the assembled CSR of phase aij", "rtol": 1e-8}
    launches, profs = {}, {}
    T = KAIJ_DT * radau_iia3()
    for key in ("maij", "kaij"):
        want = MAT7_CONTRACT[key]
        torch.cuda.synchronize()
        reset_launches()
        if key == "maij":
            pt.init(args=["-ksp_type", "cg", "-pc_type", "none", "-ksp_rtol", "1e-8",
                          "-ksp_max_it", "3000"])
            M = MatMAIJ.create(A, 3)
            b_np = maij_rhs(N)
        else:
            pt.init(args=["-ksp_type", "gmres", "-pc_type", "none", "-ksp_rtol", "1e-8",
                          "-ksp_max_it", "3000"])
            M = MatKAIJ.create(A, np.eye(3), T)
            b_np = np.ones(3 * N)
        ksp = pt.KSP().create()
        ksp.setOperators(M)
        ksp.setFromOptions()
        b = pt.Vec.from_array(b_np)
        x = M.createVecRight()
        t0 = time.perf_counter()
        ksp.solve(b, x)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        lk = launch_counts()
        its, reason = ksp.getIterationNumber(), ksp.getConvergedReason().name
        X = x.array.reshape(N, 3)
        AX = spmv.csr_spmm(ip, col, vals, X)
        r = b.array.reshape(N, 3) - (AX if key == "maij" else
                                     X + AX @ torch.as_tensor(T.T, device=X.device))
        true_rel = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b.array))
        hr = hist_rel(ksp.getConvergenceHistory(), want["history"])
        rec = {"operator": "MatMAIJ.create(A, 3)" if key == "maij" else
               "MatKAIJ.create(A, I_3, dt A_RadauIIA), dt 0.01",
               "unknowns": 3 * N, "ksp": ksp.getType(), "its": its, "reason": reason,
               "history_rel_diff_vs_reference": hr, "true_relres": true_rel,
               "reference_true_relres": want["true_relres"], "first_solve_s": first_s,
               "launches": {k: v for k, v in lk.items() if v}}
        if (its != want["its"] or reason != want["reason"] or not hr <= MAT7_HIST_TOL
                or not true_rel <= 10 * want["true_relres"]
                or not bool(torch.isfinite(x.array).all())):
            raise AssertionError(f"{key}: {rec} (want {want['its']} its, {want['reason']})")
        if key == "maij":
            need = cg_launches_needed(its, "csr_spmm")
        else:
            need = {"probe": 1, "csr_spmm": its + (its - 1) // 30, "axpy_normsq": its}
        exact_launches(key, lk, need)
        # the products against their plain versions, off the counted run
        op = M.op()
        xr = torch.as_tensor(maij_rhs(N), device=vals.device)
        Xr = xr.reshape(N, 3)
        plain = spmv.csr_spmm(ip, col, vals, Xr)
        if key == "maij":
            rec["mult_rel_err"] = rel_err(op.mult(xr).reshape(N, 3), plain)
            tp = spmv.csr_spmm(*csr_transpose_of(data, N), Xr)
            yt = op.mult_t(xr).reshape(N, 3)
            rec["mult_transpose_rel_err"] = rel_err(yt, tp)
            rec["mult_transpose_rel_err_vs_scatter_add"] = rel_err(
                yt, torch.stack([spmv.csr_spmv_t(ip, col, vals, Xr[:, c].contiguous(), N)
                                 for c in range(3)], dim=1))
            errs = [rec["mult_rel_err"], rec["mult_transpose_rel_err"],
                    rec["mult_transpose_rel_err_vs_scatter_add"]]
        else:
            Tt = torch.as_tensor(T.T, device=vals.device)
            rec["mult_rel_err"] = rel_err(op.mult(xr).reshape(N, 3), Xr + plain @ Tt)
            errs = [rec["mult_rel_err"]]
        if not max(errs) <= TOL["float64"]:
            raise AssertionError(f"{key}: products against the plain versions {errs}")
        rec["warm_ms_best_of_3"] = warm_ms(ksp, b, x)
        prof = profile_solve(ksp, b, x, rec["warm_ms_best_of_3"])
        if ksp.getIterationNumber() != its or hist_rel(ksp.getConvergenceHistory(),
                                                       want["history"]) > MAT7_HIST_TOL:
            raise AssertionError(f"{key}: the warm solves left the contract")
        rec.update(ms_per_it=rec["warm_ms_best_of_3"] / its,
                   device_busy_ms=prof["device_busy_ms"], busy_share=prof["busy_share_of_warm"],
                   device_events=prof["device_events"],
                   m1_in_solve=prof["in_solve"].get("csr_spmm"))
        out[key], launches[key], profs[key] = rec, lk, prof
        del ksp, M, b, x, X, AX, r, op, xr, Xr, plain
        torch.cuda.empty_cache()
    out["csr_spmm_edges"] = [m1_edge_check(pk, name, k, dt) for k in M1_EDGE_KS
                             for dt in (torch.float64, torch.float32)
                             for name in m1_edge_cases(k, dt.itemsize)]
    rows = m1_rows(pk, data, N, flush, earlier)
    out["csr_spmm_checks"] = rows
    out["seconds"] = time.perf_counter() - t_phase
    out["seconds_so_far"] = time.perf_counter() - t_start
    return out, launches, profs, rows[0]


# ---------------------------------------------------------------------
# phase krylov: the Krylov types of item 8 held to their contracts
# ---------------------------------------------------------------------

def krylov_contract():
    """The reference's runs of phase krylov's cases (krylov_contract.py),
    case -> its, reason, history, true relres, ..."""
    return json.loads((DATA / "krylov_contract.json").read_text())


def krylov_launches_needed(case, its, hist_len, first=True):
    """The launches of one solve of a phase krylov case, derived from each
    method's products, PC applications and vector kernels per iteration
    (petsc_tpu_torch/ksp/*.py), for the case's own settings: ILU(0) is two
    T1 sweeps per application (and its transpose two more), jacobi and none
    launch nothing; dot2 is each inner product or norm, triad each
    y + alpha x. `hist_len` is the history's length (dgmres: one entry per
    cycle; mixed: one per refinement pass); `first` adds the K8 gather that
    builds the explicit transpose's values at a CSR operator's first A^T
    product. Returns {kernel: launches}."""
    group, ksp_type = ("mixed", "mixed") if case == "mixed" else case.split("_", 1)
    n = {}

    def add(k, v):
        if v:
            n[k] = n.get(k, 0) + v

    prod = {"csr": "csr_spmv", "mixed": "csr_spmv", "grid": "dnd_stencil",
            "box": "const_stencil"}[group]
    I = its
    if group in ("csr", "mixed"):
        def pc(k):                       # k ILU(0) applications
            add("trisolve", 2 * k)
    else:
        def pc(k):
            pass
    if case == "mixed":
        # each pass: one GMRES(30) cycle in f32 (S2, two T1 sweeps and K3
        # per step, B r first), then x += s dx, r = b - A x and ||r||
        N = hist_len - 1
        add(prod, I + N)
        pc(I + N)
        add("axpy_normsq", I)
        add("dot2", 1 + N)
        add("triad", 2 * N)
        return n
    per = {   # type: (products, PC applications, dot2, triad) per iteration
        "cgs": (2, 2, 3, 7), "tfqmr": (3, 3, 4, 10), "bcgsl": (4, 4, 5, 11),
        "ibcgs": (2, 2, 7, 9), "idr": (5, 5, 9, 30), "gcr": (1, 1, 3, 2),
        "tcqmr": (3, 3, 4, 10), "qmrcgs": (2, 2, 6, 8), "cr": (1, 0, 3, 4),
        "fcg": (1, 0, 3, 2), "pipecg": (1, 0, 3, 8), "symmlq": (1, 0, 2, 7),
        "stcg": (1, 0, 3, 3)}
    if ksp_type in per:
        p, b_, d, t = per[ksp_type]
        add(prod, p * I)
        pc(b_ * I)
        add("dot2", d * I)
        add("triad", t * I)
    # the set-up before the loop, and what differs from the per-iteration sums
    if ksp_type == "cgs":
        pc(1)
        add("dot2", 1)
        add("triad", -3)                 # no u, p recurrence in the first step
    elif ksp_type == "tfqmr":
        add(prod, 1)
        pc(2)
        add("dot2", 2)
    elif ksp_type == "bcgsl":
        pc(1)
        add("dot2", 1)
    elif ksp_type == "ibcgs":
        add(prod, 2)                     # B A r0 and A^T on f0
        pc(3)                            # B r0, B A r0 and B^T r0
        add("dot2", 3)
        add("gather", int(first))
    elif ksp_type == "idr":
        add("dot2", 1)
    elif ksp_type == "lgmres":
        # one cycle (its <= restart): B b, then per step B A v and K3; the
        # update x += U^T y and ||z|| of the stored correction
        add(prod, I)
        pc(I + 1)
        add("axpy_normsq", I)
        add("dot2", 2)
        add("triad", 1)
    elif ksp_type == "dgmres":
        # restart 4: B(b - A x) (a triad) and ||r||; per cycle ||r||, 4
        # Arnoldi steps (the deflation's triad, B A, CGS2's two passes: a
        # triad and K3), x's update (the deflation's triad and x's), its
        # B(b - A x) and ||r||; after each cycle but the last, the deflation
        # basis: U + Y V (a triad), kpad = 10 rows by modified Gram-Schmidt
        # (a dot2 and a triad per pair of rows), each ||u|| and B A u
        c, m, kpad = hist_len - 1, 4, 10
        pairs = kpad * (kpad - 1) // 2
        add(prod, 1 + c * (m + 1) + kpad * (c - 1))
        pc(1 + c * (m + 1) + kpad * (c - 1))
        add("dot2", 1 + 2 * c + (kpad + pairs) * (c - 1))
        add("axpy_normsq", c * m)
        add("triad", 1 + c * (2 * m + 3) + (1 + pairs) * (c - 1))
    elif ksp_type == "gcr":
        # the two projections (A- and search direction) at every step of
        # a restart-30 cycle but its first
        add("dot2", 1)
        add("triad", 2 * (I - -(-I // 30)))
    elif ksp_type == "tcqmr":
        pc(1)
        add("dot2", 1)
    elif ksp_type == "qmrcgs":
        pc(1)
        add("dot2", 1)
    elif ksp_type == "bicg":
        # per iteration A p, A^T pt, B r, B^T rt, three dot2, five triads
        tr = "dnd_stencil_t" if group == "grid" else prod
        add(prod, I)
        add(tr, I)
        pc(2 * I + 2)
        add("dot2", 3 * I + 2)
        add("triad", 5 * I)
        if group == "csr":
            add("gather", int(first))
    elif ksp_type == "cgls":
        add(prod, I)
        add("dnd_stencil_t", I + 1)
        add("dot2", 3 * I + 2)
        add("triad", 3 * I)
    elif ksp_type == "lsqr":
        add(prod, I)
        add("dnd_stencil_t", I + 1)
        add("dot2", 2 * I + 2)
        add("triad", 4 * I)
    elif ksp_type == "cr":
        add(prod, 1)
        add("dot2", 2)
    elif ksp_type == "fcg":
        add("dot2", 1)
        add("triad", I - 1)              # the projection against the stored directions
    elif ksp_type == "pipecg":
        add(prod, 1)
        add("dot2", 1)
    elif ksp_type == "symmlq":
        add("dot2", 2)
        add("triad", -2)                 # no w, wbar, x step first; the CG point at the end
    elif ksp_type == "stcg":
        add("dot2", 2)
    return n


def krylov_operators(pt, device=None):
    """Phase krylov's operators through the user's entry points: config 2's
    stencil7 from COO triplets (the assembled CSR) and the same on its grid
    (setStencilGrid: V1, V1T), b = A cos(0.01 i); the 128^3 box27 stencil
    Mat, b = 1. Returns {group: (A, b as numpy, the host CSR, the exact
    solution or None)}."""
    import numpy as np
    import scipy.sparse as sp
    from petsc_tpu_torch.ops import stencil_build as sb
    kw = {} if device is None else {"device": device}
    pt.init(args=list(KRYLOV_CSR_ARGS), **kw)
    i, j, v = sb.stencil7_coo(*CONFIG2)
    n = int(np.prod(CONFIG2))
    A_sp = sp.csr_matrix((v, (i, j)), shape=(n, n))
    xs = np.cos(0.01 * np.arange(n))
    b2 = A_sp @ xs
    out = {}
    for group in ("csr", "grid"):
        A = pt.MatAIJ()
        A.setSizes(n)
        if group == "grid":
            A.setStencilGrid(CONFIG2)
        A.setPreallocationCOO(i, j)
        A.setValuesCOO(v)
        out[group] = (A, b2, A_sp, xs)
    N = KRYLOV_BOX_N
    bi, bj, bv = box27_coo(N)
    B_sp = sp.csr_matrix((bv, (bi, bj)), shape=(N ** 3, N ** 3))
    out["box"] = (sb.as_mat(*sb.build_dnd((N,) * 3, kind="box")), np.ones(N ** 3), B_sp, None)
    return out


def krylov_ksp(pt, group, ksp_type, A, shared_pc=None, device=None):
    """A KSP for one case with the case's options: the CSR cases share one
    PC (ILU(0) with -pc_factor_transpose_solve, set up once), the grid cases
    take their own PC, the box cases jacobi and their max_it, stcg its
    radius, the mixed case setMixedPrecision(). Each case starts with an
    init() of its own options (K1 once, before its launches are counted)."""
    if group == "box":
        args = (*KRYLOV_BOX_ARGS, "-ksp_max_it", str(KRYLOV_BOX_MAX_IT[ksp_type]))
    elif group == "grid":
        args = ("-ksp_rtol", "1e-8", "-ksp_max_it", "400", "-pc_type",
                KRYLOV_GRID_PCS[ksp_type])
    else:
        args = (*KRYLOV_CSR_ARGS, *KRYLOV_CSR_EXTRA.get(ksp_type, ()))
    pt.init(args=list(args), **({} if device is None else {"device": device}))
    ksp = pt.KSP().create()
    ksp.setOperators(A)
    if shared_pc is not None:
        ksp.setPC(shared_pc)
    if ksp_type != "mixed":
        ksp.setType(ksp_type)
    ksp.setFromOptions()
    if ksp_type == "stcg":
        ksp.setRadius(KRYLOV_STCG_RADIUS)
    if ksp_type == "mixed":
        ksp.setMixedPrecision()
    return ksp


KRYLOV_CASES = (tuple(f"csr_{t}" for t in KRYLOV_CSR_TYPES)
                + tuple(f"grid_{t}" for t in KRYLOV_GRID_PCS) + ("mixed",)
                + tuple(f"box_{t}" for t in KRYLOV_BOX_MAX_IT))


def krylov_solve(pt, case, ops, shared, device=None):
    """One case's first solve, every launch count set to 0 just before it
    and read just after: returns (ksp, b, x, launches, whether the solve
    found no explicit transpose's values yet). `shared` keeps the CSR
    cases' PC, set up by the first of them."""
    import torch
    group, ksp_type = ("mixed", "mixed") if case == "mixed" else case.split("_", 1)
    A = ops["csr" if group == "mixed" else group][0]
    ksp = krylov_ksp(pt, group, ksp_type, A,
                     shared.get("pc") if group in ("csr", "mixed") else None, device)
    if group in ("csr", "mixed"):
        shared["pc"] = ksp.getPC()
    b = pt.Vec.from_array(ops["csr" if group == "mixed" else group][1])
    x = A.createVecRight()
    if device is None:
        torch.cuda.synchronize()
    fresh_t = "csr_t_vals" not in A.device_data()
    reset_launches()
    ksp.solve(b, x)
    if device is None:
        torch.cuda.synchronize()
    return ksp, b, x, launch_counts(), fresh_t


def check_krylov(case, ksp, b, x, ops, contract):
    """The solve against the reference's run of the case: its and reason,
    the history (KRYLOV_HIST_TOL relative, plus KRYLOV_HIST_ATOL of the
    initial norm where the case has one), a true relative residual <= 10x
    the reference's, finite values of the right shape. The mixed case:
    the first refinement pass takes the reference's its (both solve the
    same f32 right-hand side); every later pass solves for the residual
    the f32 solve before it left, which is rounding, and may take one
    iteration more or fewer (the reference's own inner solve takes the
    port's count on the port's right-hand side); the outer norms after the
    first within KRYLOV_IR_FACTOR of the reference's."""
    import numpy as np
    import torch
    group = "csr" if case == "mixed" else case.split("_", 1)[0]
    A_sp = ops[group][2]
    xh = x.array.double().cpu().numpy()
    bh = b.array.double().cpu().numpy()
    if xh.shape != bh.shape or not bool(torch.isfinite(x.array).all()):
        raise AssertionError(f"krylov {case}: solution of shape {xh.shape} or not finite")
    want = contract[case]
    h, hw = ksp.getConvergenceHistory(), np.asarray(want["history"])
    got = {"its": ksp.getIterationNumber(), "reason": ksp.getConvergedReason().name,
           "ksp_type": ksp.getType(), "pc_type": ksp.getPC().getType(),
           "true_relres": float(np.linalg.norm(bh - A_sp @ xh) / np.linalg.norm(bh)),
           "history_len": len(h)}
    tol, atol = KRYLOV_HIST_TOL, KRYLOV_HIST_ATOL.get(case, 0.0) * hw[0]
    ok_its = got["its"] == want["its"]
    if len(h) != len(hw):
        ok_hist = False
    elif case == "mixed":
        got["pass_its"] = list(ksp._pass_its)
        got["history_ratio"] = [float(v) for v in h[1:] / hw[1:]]
        ok_hist = bool(abs(h[0] - hw[0]) <= tol * hw[0]
                       and np.all(np.abs(np.log(h[1:] / hw[1:])) <= np.log(KRYLOV_IR_FACTOR)))
        want_p = want["pass_its"]
        ok_its = (len(got["pass_its"]) == len(want_p) and got["pass_its"][0] == want_p[0]
                  and all(abs(g - w) <= 1 for g, w in zip(got["pass_its"], want_p)))
    else:
        got["history_rel_err"] = float(np.max(np.abs(h - hw) / np.abs(hw)))
        got["history_err_of_initial"] = float(np.max(np.abs(h - hw)) / hw[0])
        ok_hist = bool(np.all(np.abs(h - hw) <= tol * np.abs(hw) + atol))
    if not ok_its or got["reason"] != want["reason"] or not ok_hist \
            or not got["true_relres"] <= 10 * want["true_relres"]:
        raise AssertionError(f"krylov {case} against the reference: got {got}, want its "
                             f"{want['its']} ({want.get('pass_its')}), {want['reason']}, "
                             f"history to {tol} (+{atol}), true relres <= 10 x "
                             f"{want['true_relres']}")
    return got


def exact_krylov_launches(case, launches, its, hist_len, first=True):
    need = krylov_launches_needed(case, its, hist_len, first)
    wrong = {k: (launches.get(k, 0), v) for k, v in need.items() if launches.get(k, 0) != v}
    others = {k: v for k, v in launches.items() if v and k not in need}
    if wrong or others:
        raise AssertionError(f"krylov {case}: launches (got, need) {wrong}; others {others}")
    return need


def v1t_row(A, flush):
    """V1T (dnd_stencil_t) on config 2's grid operator, f64, 7 planes:
    equal bits with its plain version (the gather form) on the card, and
    timed after the clean flush beside it and beside V1 (the forward
    product, its window kernel's scalar variant on the odd grid); the bound
    is x and the planes read once and y written once, the same for both."""
    import torch
    from petsc_tpu_torch.ops import grid_kernels as gridk
    op = A.op()
    meta, data = A.meta, A.device_data()
    shape, offs = meta[1], meta[2]
    cvals = meta[6] if len(meta) > 6 else (None,) * len(offs)
    n = int(A.getSize()[0])
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.rand(n, dtype=torch.float64, device="cuda", generator=g) - 0.5
    y = op.mult_t(x)
    yp = gridk.dnd_stencil_t(x, shape, offs, cvals, data["coef"])
    planes = int(data["coef"].shape[0])
    nbytes = (2 + planes) * n * 8
    flops = 2 * len(offs) * n
    ms = time_ms(lambda: op.mult_t(x), flush)
    plain_ms = time_ms(lambda: gridk.dnd_stencil_t(x, shape, offs, cvals, data["coef"]),
                       flush, reps=5)
    bms, by = bound(nbytes, flops, "float64")
    fwd_ms = time_ms(lambda: op.mult(x), flush)
    return {"name": "dnd_stencil_t", "dtype": "float64", "shape": list(shape),
            "planes": planes, "kernel": "generic (V1's, transposed stencil)",
            "equal_bits": bool(torch.equal(y, yp)), "max_abs_err": float((y - yp).abs().max()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "share_of_bound": bms / ms, "library_ms": None,
            "library": "none: no single PyTorch call computes the stencil's transpose product",
            "forward_v1_ms": fwd_ms, "forward_v1_share_of_bound": bms / fwd_ms,
            "forward_v1_kernel": op.mult.kernel,
            "planes_MB": data["coef"].numel() * 8 / 2 ** 20}


def phase_krylov(pt, smi, t_start, flush):
    """Phase krylov: each case of KRYLOV_CASES through the user's entry
    points, its first solve held to the reference's contract with its
    launches counted exactly; then the warm time (best of 3) and one
    profiled solve (busy ms and share); V1T's row. Returns (the record,
    V1T's row, the launches summed over the cases' first solves, the grid
    bicg case's launches)."""
    import torch
    contract = krylov_contract()
    t0 = time.perf_counter()
    ops = krylov_operators(pt)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    shared, cases, total, grid_launches = {}, {}, {}, None
    for case in KRYLOV_CASES:
        t1 = time.perf_counter()
        ksp, b, x, launches, fresh_t = krylov_solve(pt, case, ops, shared)
        first_s = time.perf_counter() - t1
        got = check_krylov(case, ksp, b, x, ops, contract)
        need = exact_krylov_launches(case, launches, got["its"], got["history_len"], fresh_t)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        if case == "grid_bicg":
            grid_launches = launches
        ms = warm_ms(ksp, b, x)
        prof = profile_solve(ksp, b, x, ms)
        check_krylov(case, ksp, b, x, ops, contract)
        cases[case] = {**got, "first_solve_s": first_s, "warm_ms_best_of_3": ms,
                       "ms_per_it": ms / max(got["its"], 1),
                       "device_busy_ms": prof["device_busy_ms"],
                       "busy_share": prof["busy_share_of_warm"],
                       "device_events": prof["device_events"],
                       "spins_seen_before_and_after": prof["spins_seen_before_and_after"],
                       "launches": {k: v for k, v in need.items()},
                       "by_kernel": prof["by_kernel"][:6]}
        del ksp, b, x
    row = v1t_row(ops["grid"][0], flush)
    if not row["equal_bits"]:
        raise AssertionError(f"V1T differs from its plain version: {row['max_abs_err']}")
    rec = {"phase": "krylov", "nvidia_smi": smi, "operators_setup_s": setup_s,
           "config2": list(CONFIG2), "box_n": KRYLOV_BOX_N,
           "kinds": {g: ops[g][0].meta[0] for g in ("csr", "grid", "box")},
           "cases": cases, "dnd_stencil_t": row,
           "seconds_so_far": time.perf_counter() - t_start}
    if rec["kinds"] != {"csr": "aij_csr", "grid": "aij_dnd", "box": "aij_dnd"}:
        raise AssertionError(f"krylov operators: {rec['kinds']}")
    return rec, row, total, grid_launches

# ---------------------------------------------------------------------
# phase pc: the PC types of item 8 held to their contracts, and the three
# kernels of the domain-decomposition PCs (X1, D1, N1)
# ---------------------------------------------------------------------

def pc_contract():
    """The reference's runs of phase pc's cases (pc_contract.py), case ->
    its, reason, history, true relres, ..."""
    return json.loads((DATA / "pc_contract.json").read_text())


def pc_operator(pt, group, ex56_op=None):
    """One operator group of PC_CASES through the user's entry points:
    config 2 from COO triplets (on its grid for config2_grid), the 128^3
    box27 by MatAIJ.from_scipy (aij_csr, S2), ex56's ne 64 CSR (phase ex56's
    assembly, `ex56_op` = (CSR, b)) with setBlockSize(3), the ex59-class
    MatIS from stencil_build.matis_poisson. Returns (Mat, b as numpy, the
    host CSR of the operator)."""
    import numpy as np
    import scipy.sparse as sp
    from petsc_tpu_torch.ops import stencil_build as sb
    if group.startswith("config2"):
        i, j, v = sb.stencil7_coo(*CONFIG2)
        n = int(np.prod(CONFIG2))
        A_sp = sp.csr_matrix((v, (i, j)), shape=(n, n))
        A = pt.MatAIJ()
        A.setSizes(n)
        if group == "config2_grid":
            A.setStencilGrid(CONFIG2)
        A.setPreallocationCOO(i, j)
        A.setValuesCOO(v)
        return A, A_sp @ np.cos(0.01 * np.arange(n)), A_sp
    if group == "box":
        N = KRYLOV_BOX_N
        bi, bj, bv = box27_coo(N)
        A_sp = sp.csr_matrix((bv, (bi, bj)), shape=(N ** 3, N ** 3))
        return pt.MatAIJ.from_scipy(A_sp), np.ones(N ** 3), A_sp
    if group == "ex56":
        A_sp, b_np = ex56_op
        A = pt.MatAIJ.from_scipy(A_sp)
        A.setBlockSize(3)
        return A, b_np, A_sp
    ne, nsub = PC_MATIS if group == "matis" else PC_MATIS_NN
    mats, maps, n = sb.matis_poisson(ne, nsub)
    M = pt.MatIS.create(n, mats, maps)
    rows, cols, vals = [], [], []
    for Ai, gi in zip(mats, maps):
        c = sp.coo_matrix(Ai)
        rows.append(gi[c.row])
        cols.append(gi[c.col])
        vals.append(c.data)
    A_sp = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                         shape=(n, n))
    return M, pc_rhs_matis(n), A_sp


def pc_ksp(pt, case, A, device=None):
    """The case's KSP: init() with its options, rtol and max_it, the
    operator, ex56's unpreconditioned norm, setFromOptions."""
    group, args = PC_CASES[case]
    pt.init(args=[*args, "-ksp_rtol", str(PC_RTOL[group]), "-ksp_max_it", str(PC_MAX_IT[group])],
            **({} if device is None else {"device": device}))
    ksp = pt.KSP().create()
    ksp.setOperators(A)
    if group == "ex56":
        ksp.setNormType("unpreconditioned")
    ksp.setFromOptions()
    return ksp


def pc_solve(pt, case, op, device=None):
    """One case's set-up (timed on the host) and first solve, every launch
    count set to 0 just before the solve and read just after: returns
    (ksp, b, x, launches, set-up seconds)."""
    import torch
    cuda = device is None
    A, b_np, _ = op
    ksp = pc_ksp(pt, case, A, device)
    b = pt.Vec.from_array(b_np)
    x = A.createVecRight()
    t0 = time.perf_counter()
    ksp.setUp()
    if ksp.getType() == "fetidp":      # its set-up comes with the first solve
        from petsc_tpu_torch.ksp import fetidp
        fetidp.tables_for(ksp, b.array)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reset_launches()
    ksp.solve(b, x)
    if cuda:
        torch.cuda.synchronize()
    return ksp, b, x, launch_counts(), setup_s


def _mg_apply_launches(nlev, product0="csr_spmv"):
    """One V-cycle of Chebyshev(2, 2) on nlev levels (mg_launches_needed's
    per-application part): 4 C1, 7 products (level 0's on product0, its P
    and R on S2) and 2 K2 on each level but the coarsest."""
    fine = nlev - 1
    n = {"cheby_update": 4 * fine, "csr_spmv": 7 * fine, "triad": 2 * fine}
    if product0 != "csr_spmv" and fine:
        n["csr_spmv"] -= 5
        n[product0] = 5
    return n


def pc_launches_needed(case, its, reason, detail):
    """The launches of one solve of a phase pc case, derived from the
    Krylov method's products and PC applications per iteration and each
    PC's kernels per application (petsc_tpu_torch/pc/*.py, ksp/*.py).
    `detail`: the case's data-dependent counts (the PCKSP inner its per
    application, the GAMG levels of each sub-PC). Returns {kernel: n}."""
    import math
    group, _ = PC_CASES[case]
    n = {}

    def add(k, v, times=1):
        if v * times:
            n[k] = n.get(k, 0) + v * times

    def add_all(d, times=1):
        for k, v in d.items():
            add(k, v, times)

    prod = {"config2": "csr_spmv", "config2_grid": "dnd_stencil", "box": "csr_spmv",
            "ex56": "bsr_spmv"}.get(group)
    per_pc = {
        "c2_asm": {"gather": 1, "trisolve": 2, "dst_scatter": 1},
        "c2_asm_basic8": {"gather": 1, "trisolve": 2, "dst_scatter": 1},
        "c2_neumann": {"dnd_stencil": 12, "triad": 6, "neumann_step": 7},
        "c2_bjacobi_subksp": {"trisolve": 2},
        "box_composite": {"trisolve": 2, "triad": 1},
        "matis_bddc": {"subdomain_apply": 3, "dst_scatter": 2},
        "matis_nn": {"subdomain_apply": 2, "dst_scatter": 2, "triad": 1},
    }
    if case == "matis_fetidp":
        conv = reason.startswith("CONVERGED")
        if its == 0:
            return {"dst_scatter": 7, "subdomain_apply": 7, "dot2": 2, "triad": 1}
        return {"subdomain_apply": 7 + 4 * its, "dst_scatter": 8 + 5 * its,
                "dot2": 2 + 3 * its, "triad": 2 * its + (its - 1 if conv else its) + 1}
    if group.startswith("config2"):
        # GMRES(30) / FGMRES: one product, one PC and one K3 per step; a new
        # cycle's b - A x; GMRES's B r at each cycle's start
        cycles = max(1, math.ceil(its / 30))
        add(prod, its + cycles - 1)
        add("axpy_normsq", its)
        napply = its + (cycles if PC_CASES[case][1][1] == "gmres" else 0)
        add_all(per_pc[case], napply)
        return n
    # CG: one product, two K2, one K3 and two K4 per iteration, one K4 first
    cg = {"triad": 2 * its, "axpy_normsq": its, "dot2": 1 + 2 * its}
    if case == "box_pcksp":
        # FGMRES (one product and K3 per step, no PC at a cycle's start) around
        # an inner CG + jacobi (CG's launches per its inner iterations)
        cycles = max(1, math.ceil(its / 30))
        add("csr_spmv", its + cycles - 1)
        add("axpy_normsq", its)
        for k in detail["inner_its"]:
            add_all({"csr_spmv": k, "triad": 2 * k, "axpy_normsq": k, "dot2": 1 + 2 * k})
        return n
    add_all(cg)
    napply = its + 1
    if group in ("matis", "matis_nn"):
        add_all({"subdomain_apply": 1, "dst_scatter": 1}, its)
        add_all(per_pc[case], napply)
    elif case == "box_classical":
        add("csr_spmv", its)
        add_all(_mg_apply_launches(detail["levels"][0]), napply)
    elif case == "ex56_fieldsplit":
        add("bsr_spmv", its)
        add_all({"gather": 3, "dst_scatter": 3}, napply)
        for nlev in detail["levels"]:
            add_all(_mg_apply_launches(nlev), napply)
    else:
        add(prod, its)
        add_all(per_pc[case], napply)
    return n


def pc_detail(case, ksp):
    """The counts pc_launches_needed takes from the solved case."""
    impl = ksp.getPC()._impl
    if case == "box_pcksp":
        return {"inner_its": list(ksp.getPC().device_data()["inner_its"])}
    if case == "box_classical":
        return {"levels": [len(impl.levels)]}
    if case == "ex56_fieldsplit":
        return {"levels": [len(p._impl.levels) for p in impl.sub_pcs]}
    return {}


def check_pc(case, ksp, b, x, A_sp, contract):
    """The solve against the reference's run of the case: its and reason,
    the history to PC_HIST_TOL relative where an entry lies above the
    rounding level (1e-11 of the initial norm: below it, 1e-11 of the
    initial norm absolute; NN over its first PC_HIST_PREFIX entries), a
    true relative residual <= 10x the reference's, finite values of the
    right shape."""
    import numpy as np
    import torch
    xh = x.array.double().cpu().numpy()
    bh = b.array.double().cpu().numpy()
    if xh.shape != bh.shape or not bool(torch.isfinite(x.array).all()):
        raise AssertionError(f"pc {case}: solution of shape {xh.shape} or not finite")
    want = contract[case]
    h, hw = ksp.getConvergenceHistory(), np.asarray(want["history"])
    got = {"its": ksp.getIterationNumber(), "reason": ksp.getConvergedReason().name,
           "ksp_type": ksp.getType(), "pc_type": ksp.getPC().getType(),
           "true_relres": float(np.linalg.norm(bh - A_sp @ xh) / np.linalg.norm(bh)),
           "history_len": len(h)}
    ok_hist = len(h) == len(hw)
    if ok_hist:
        k = PC_HIST_PREFIX.get(case, len(hw))
        got["history_rel_err"] = float(np.max(np.abs(h[:k] - hw[:k]) / np.abs(hw[:k])))
        got["history_err_of_initial"] = float(np.max(np.abs(h[:k] - hw[:k])) / hw[0])
        got["history_entries_held"] = k
        ok_hist = bool(np.all(np.abs(h[:k] - hw[:k]) <= PC_HIST_TOL * np.abs(hw[:k])
                              + 1e-11 * hw[0]))
    if got["its"] != want["its"] or got["reason"] != want["reason"] or not ok_hist \
            or not got["true_relres"] <= 10 * want["true_relres"]:
        raise AssertionError(f"pc {case} against the reference: got {got}, want its "
                             f"{want['its']}, {want['reason']}, history to {PC_HIST_TOL}, "
                             f"true relres <= 10 x {want['true_relres']}")
    return got


def exact_pc_launches(case, launches, its, reason, detail):
    need = pc_launches_needed(case, its, reason, detail)
    wrong = {k: (launches.get(k, 0), v) for k, v in need.items() if launches.get(k, 0) != v}
    others = {k: v for k, v in launches.items() if v and k not in need}
    if wrong or others:
        raise AssertionError(f"pc {case}: launches (got, need) {wrong}; others {others}")
    return need


# ---- X1 and D1: their edge cases, another library's entry points, the rows ----

# D1's edge cases: name -> (subdomains, R, C, transposed, weighted, an output
# map with accumulate, M one element past a 16-byte edge). Every case has
# real counts nr < R and nc < C in most subdomains (one full, one empty
# where there are four or more), its padding NaN. Rows of 1,089 are 8 mod 16
# bytes in f64 and 4 mod 16 in f32; R C odd puts every other subdomain's
# base off a 16-byte edge; R = 65 is a run of 64 rows and a one-row tail.
D1_EDGES = {
    "rows_1089": (3, 70, 1089, False, True, False, False),
    "one_row_tail": (4, 65, 1089, False, False, False, False),
    "one_row": (9, 1, 1089, False, True, False, False),
    "c1": (5, 1089, 1, False, True, False, False),
    "c4": (5, 1089, 4, False, True, False, False),
    "c16": (5, 1089, 16, False, False, False, False),
    "c17": (5, 1089, 17, False, True, False, False),
    "c33": (5, 1089, 33, False, True, False, False),
    "t_c1": (5, 1089, 1, True, True, False, False),
    "t_c4": (5, 1089, 4, True, True, False, False),
    "t_c16": (5, 1089, 16, True, False, False, False),
    "t_c17": (5, 1089, 17, True, True, False, False),
    "t_c33": (5, 1089, 33, True, True, False, False),
    "t_c70": (4, 1089, 70, True, True, False, False),
    "offset_rows": (3, 65, 1089, False, True, False, True),
    "offset_c4": (5, 1089, 4, False, True, False, True),
    "offset_t_c4": (5, 1089, 4, True, True, False, True),
    "out_accumulate": (4, 65, 1089, False, True, True, False),
    "out_accumulate_c4": (5, 1089, 4, False, True, True, False),
    "t_out_accumulate_c4": (5, 1089, 4, True, False, True, False),
}


def d1_edge_operands(name, dtype, device, seed=41, extra=0):
    """(M, table, x, transposed, y0 or None) of D1_EDGES[name] on `device`,
    from `seed`; with `extra` more subdomains after the case's own (the
    same first ones, for another grid)."""
    import numpy as np
    import torch
    from petsc_tpu_torch.ops import pc_kernels as pck
    ns, R, C, transposed, weighted, with_out, offset = D1_EDGES[name]
    rng = np.random.default_rng(seed)
    nx = 3000
    K, R_out = (R, C) if transposed else (C, R)
    nr = rng.integers(R // 2, R + 1, ns)
    nc = rng.integers(C // 2, C + 1, ns)
    nr[0], nc[0] = R, C
    if ns >= 4:
        nr[1] = 0
    Mh = rng.random((ns, R, C)) - 0.5
    Mh[(np.arange(R)[None, :, None] >= nr[:, None, None])
       | (np.arange(C)[None, None, :] >= nc[:, None, None])] = np.nan
    G = rng.integers(0, nx, (ns, K))
    w = rng.random((ns, K)) + 0.5 if weighted else None
    ld = R_out + 5
    out = None
    if with_out:
        out = np.stack([rng.permutation(ld)[:R_out] for _ in range(ns)])
        out[:, ::7] = -1
    y0 = rng.random((ns, ld)) if with_out else None
    xh = rng.random(nx) - 0.5
    if extra:
        e = rng.integers(0, ns, extra)
        Mh, G, nr, nc = (np.concatenate([a, a[e]]) for a in (Mh, G, nr, nc))
        w = None if w is None else np.concatenate([w, w[e]])
        out = None if out is None else np.concatenate([out, out[e]])
        y0 = None if y0 is None else np.concatenate([y0, y0[e]])
    M = torch.as_tensor(Mh, dtype=dtype, device=device)
    if offset:
        M = shifted_block(M, 1)
    tab = pck.subdomain_table(G, w, out=out, nr=nr, nc=nc, device=device, dtype=dtype)
    return (M, tab, torch.as_tensor(xh, dtype=dtype, device=device), transposed,
            None if y0 is None else torch.as_tensor(y0, dtype=dtype, device=device))


def zero_padding(M, tab):
    """A copy of D1's table M with its padding (rows at or past nr[s],
    columns at or past nc[s]) set to 0: the plain version's input where the
    padding the kernel is given holds NaN."""
    import torch
    ns, R, C = M.shape
    keep = torch.ones((ns, R, C), dtype=torch.bool, device=M.device)
    if tab.nr is not None:
        keep &= torch.arange(R, device=M.device)[None, :, None] < tab.nr.long()[:, None, None]
    if tab.nc is not None:
        keep &= torch.arange(C, device=M.device)[None, None, :] < tab.nc.long()[:, None, None]
    return torch.where(keep, M, torch.zeros((), dtype=M.dtype, device=M.device))


def d1_edge_check(pck, name, dtype, device="cuda"):
    """D1 on one edge case against its plain version run in float64 on the
    same inputs with the padding zeroed (f64 1e-12, f32 1e-5 relative; the
    NaN padding the kernel is given must not reach the result), in one
    launch, with equal bits on a rerun and for the case's subdomains when
    five more follow them (another grid). Raises; returns the record."""
    import torch
    M, tab, x, transposed, y0 = d1_edge_operands(name, dtype, device)
    acc = y0 is not None

    def run(M, tab, x, y0):
        return pck.subdomain_apply(M, tab, x, transposed, y=None if y0 is None else y0.clone(),
                                   accumulate=acc)

    pck.reset_launches()
    y = run(M, tab, x, y0)
    launches = pck.LAUNCHES["subdomain_apply"]
    tab64 = pck.SubdomainTable(tab.G, None if tab.w is None else tab.w.double(), tab.out,
                               tab.nr, tab.nc)
    ref = pck.subdomain_apply_plain(zero_padding(M.double(), tab), tab64, x.double(),
                                    transposed, None if y0 is None else y0.double().clone(),
                                    acc)
    M2, tab2, x2, _, y02 = d1_edge_operands(name, dtype, device, extra=5)
    y2 = run(M2, tab2, x2, y02)
    same = bool(torch.equal(y, run(M, tab, x, y0)) and torch.equal(y, y2[:M.shape[0]]))
    torch.cuda.synchronize()
    dn = str(dtype).replace("torch.", "")
    err = rel_err(y, ref)
    if not err <= TOL[dn] or not same or launches != 1:
        raise AssertionError(f"subdomain_apply {name} {dn}: rel err {err} (tol {TOL[dn]}), "
                             f"equal bits on a rerun and another grid {same}, "
                             f"launches {launches}")
    return {"name": f"subdomain_apply_{name}", "dtype": dn, "shape": list(M.shape),
            "transposed": transposed, "rel_err": err, "equal_bits_rerun_and_grid": same}


# X1's edge cases (5,000 destinations, a source of 7,000): name -> mode
X1_EDGES = {"random_add": "add", "random_set": "set", "random_signed": "signed",
            "run_5000": "add", "run_5000_weighted": "weighted", "runs_at_long_run": "weighted",
            "runs_1_to_40": "add", "empty_rows_set": "set", "random_min": "min",
            "run_5000_min": "min", "runs_at_long_run_min": "min"}


def x1_edge_operands(name, dtype, device, seed=42, pad=0, n=5000, nsrc=7000):
    """(table, src, out or None) of X1_EDGES[name] on `device` from `seed`:
    random entries; a destination of 5,000 entries among random ones
    (entries interleaved, so their order is the input's); runs of
    LONG_RUN - 1 to 2 LONG_RUN + 3 entries; destination d with d mod 41
    entries; set mode with half the destinations reached and a long one.
    With `pad`, the table has pad more destinations after the n, which no
    entry reaches."""
    import numpy as np
    import torch
    from petsc_tpu_torch.ops import pc_kernels as pck
    rng = np.random.default_rng(seed)
    mode = X1_EDGES[name]
    L = pck.LONG_RUN
    if name == "random_set":
        dst = rng.permutation(n)[:3000]
    elif name.startswith("run_5000"):
        dst = rng.permutation(np.r_[np.full(5000, 17), rng.integers(0, n, 3000)])
    elif name.startswith("runs_at_long_run"):
        lens = np.resize([L - 1, L, L + 1, 2 * L + 3, 1, 0], n)
        dst = rng.permutation(np.repeat(np.arange(n), lens))
    elif name == "runs_1_to_40":
        dst = np.repeat(np.arange(n), np.arange(n) % 41)
    elif name == "empty_rows_set":
        dst = rng.permutation(np.r_[rng.permutation(n)[:2500], np.full(300, 11)])
    else:
        dst = rng.integers(0, n, 20000)
    sel = rng.integers(0, nsrc, len(dst))
    w = {"signed": rng.choice([-1.0, 1.0], len(dst)),
         "weighted": rng.random(len(dst)) - 0.5}.get(mode)
    tab = pck.scatter_table(dst, sel, n + pad, nsrc, w, device=device, dtype=dtype)
    src = torch.as_tensor(rng.random(nsrc) - 0.5, dtype=dtype, device=device)
    out = torch.as_tensor(rng.random(n + pad), dtype=dtype, device=device) \
        if mode in ("set", "min") else None
    return tab, src, out


def x1_edge_check(pck, name, dtype, device="cuda"):
    """X1 on one edge case: equal bits with its plain version, on a rerun
    and for the case's destinations when 3 x 1024 empty ones follow them
    (another grid), in one launch. Raises; returns the record."""
    import torch
    tab, src, out = x1_edge_operands(name, dtype, device)
    mode = "min" if X1_EDGES[name] == "min" else None

    def run(tab, out):
        return pck.dst_scatter(tab, src, None if out is None else out.clone(), mode=mode)

    pck.reset_launches()
    y = run(tab, out)
    launches = pck.LAUNCHES["dst_scatter"]
    yp = pck.dst_scatter_plain(tab, src, None if out is None else out.clone(), mode)
    tab2, _, out2 = x1_edge_operands(name, dtype, device, pad=3 * 1024)
    same = bool(torch.equal(y, run(tab, out)) and torch.equal(y, run(tab2, out2)[:tab.n]))
    torch.cuda.synchronize()
    if not torch.equal(y, yp) or not same or launches != 1:
        raise AssertionError(f"dst_scatter {name} {dtype}: equal bits with the plain version "
                             f"{torch.equal(y, yp)}, on a rerun and another grid {same}, "
                             f"launches {launches}")
    return {"name": f"dst_scatter_{name}", "dtype": str(dtype).replace("torch.", ""),
            "entries": tab.entries, "long_destinations": tab.nlong, "equal_bits": True}


def d1_call(fn, M, tab, x, transposed=False, y=None, accumulate=False):
    """D1 through the earlier design's entry point fn, with the arguments
    pc_kernels.subdomain_apply gives its own, on the current stream; raises
    on a CUDA error."""
    import torch
    from petsc_tpu_torch.ops import cuda_build
    ns, R, C = M.shape
    if y is None:
        y = torch.empty((ns, C if transposed else R), dtype=M.dtype, device=M.device)

    def p(t):
        return None if t is None else t.data_ptr()

    cuda_build.check("d1_call", fn(int(transposed), y.data_ptr(), M.data_ptr(), x.data_ptr(),
                                   tab.G.data_ptr(), p(tab.w), p(tab.out), p(tab.nr), p(tab.nc),
                                   ns, R, C, y.shape[1], int(accumulate), M.get_device(),
                                   torch.cuda.current_stream().cuda_stream))
    return y


def x1_call(fn, tab, src, out=None):
    """X1 through the earlier design's entry point fn, with the arguments
    pc_kernels.dst_scatter gives its own but the list of long destinations,
    which it does not take; raises on a CUDA error."""
    import torch
    from petsc_tpu_torch.ops import cuda_build
    y = torch.empty(tab.n, dtype=src.dtype, device=src.device) if out is None else out
    w = None if tab.w is None else tab.w.data_ptr()
    cuda_build.check("x1_call", fn(y.data_ptr(), src.data_ptr(), tab.ptr.data_ptr(),
                                   tab.sel.data_ptr(), w, tab.n, int(out is not None),
                                   src.get_device(), torch.cuda.current_stream().cuda_stream))
    return y


def earlier_entry(earlier, name, dtype):
    """The earlier design's entry point ptt_earlier_<name>_<f64|f32>."""
    import torch
    return getattr(earlier, f"ptt_earlier_{name}_" + ("f64" if dtype == torch.float64 else "f32"))


def pc_kernel_row(name, dtype, fn, plain, library_fn, nbytes, flops, flush, exact, library,
                  earlier=None, timed=None):
    """One kernel's row: its result against its plain version on the same
    inputs (equal bits where `exact`, else 1e-12 / 1e-5 relative) and on a
    rerun (equal bits), the earlier design's held to the same; the kernel
    and the earlier design timed in turns (earlier, new, new, earlier: each
    the mean of its two), the plain version and the library call after the
    clean flush. `timed` = (kernel, plain, earlier, library) to time where
    the checked calls copy their output buffer first."""
    import torch
    y = fn()
    yp = plain()
    ye = earlier() if earlier is not None else None
    rerun = bool(torch.equal(y, fn()))
    torch.cuda.synchronize()
    err = float((y.double() - yp.double()).abs().max())
    rel = rel_err(y, yp)
    e_ok = ye is None or (torch.equal(ye, yp) if exact else rel_err(ye, yp) <= TOL[dtype])
    if (exact and not torch.equal(y, yp)) or (not exact and not rel <= TOL[dtype]) \
            or not rerun or not e_ok:
        raise AssertionError(f"{name}: differs from its plain version ({err}, {rel}), "
                             f"equal bits on a rerun {rerun}, the earlier design agrees {e_ok}")
    t_fn, t_plain, t_earlier, t_lib = timed or (fn, plain, earlier, library_fn)
    bms, by = bound(nbytes, flops, dtype)
    row = {"name": name, "dtype": dtype, "equal_bits": bool(torch.equal(y, yp)),
           "equal_bits_rerun": rerun, "max_abs_err": err, "rel_err": rel}
    if earlier is not None:
        fns = {"earlier": t_earlier, "new": t_fn}
        order = ("earlier", "new", "new", "earlier")
        t = [time_ms(fns[o], flush) for o in order]
        mean = {o: statistics.mean(v for oo, v in zip(order, t) if oo == o) for o in fns}
        ms = mean["new"]
        row.update(earlier_ms=mean["earlier"], turns=order, turns_ms=t,
                   earlier_share_of_bound=bms / mean["earlier"])
    else:
        ms = time_ms(t_fn, flush)
    row.update(ms=ms, plain_ms=time_ms(t_plain, flush, reps=5),
               library_ms=time_ms(t_lib, flush) if t_lib is not None else None,
               library=library, bound_ms=bms, bound_by=by, share_of_bound=bms / ms,
               bytes=nbytes)
    return row


def x1_bytes(tab, itemsize):
    """X1's bytes: ptr, sel (and w) and the long list read once, y written
    once, the 32-byte sectors of src that sel touches read once."""
    import torch
    sectors = torch.unique(tab.sel.long() * itemsize // 32).numel()
    return ((tab.n + 1) * 4 + tab.entries * 4 + (tab.entries * itemsize if tab.w is not None
                                                 else 0) + tab.n * itemsize + sectors * 32
            + tab.nlong * 12)


def d1_bytes(M, tab, transposed, accumulate):
    """D1's bytes: the real entries of M read once, the gather's real
    entries (G and w, where there is one, read once each; x as the distinct
    entries they gather) and the output written once (read too with
    accumulate, its map read once)."""
    import torch
    ns, R, C = M.shape
    isz = M.element_size()
    nr = tab.nr.long() if tab.nr is not None else torch.full((ns,), R, device=M.device)
    nc = tab.nc.long() if tab.nc is not None else torch.full((ns,), C, device=M.device)
    real = int((nr * nc).sum())
    K = tab.G.shape[1]
    used = torch.arange(K, device=tab.G.device)[None, :] < (nr if transposed else nc)[:, None]
    g = int(used.sum())
    distinct = torch.unique(tab.G[used]).numel()
    nout = ns * (C if transposed else R)
    return (real * isz + g * 4 + distinct * isz + (g * isz if tab.w is not None else 0)
            + nout * isz * (2 if accumulate else 1) + (nout * 4 if tab.out is not None else 0)), real


def x1_row(label, tab, flush, earlier, gen):
    """X1's row on `tab` (f64) in its mode (add, set, signed or min):
    against its plain version bit for bit, the earlier thread-per-
    destination design in turns (it has no min mode), and as the library
    call index_add_ after the gather (atomic), or scatter_reduce's amin in
    min mode."""
    import torch
    from petsc_tpu_torch.ops import pc_kernels as pck
    src = torch.rand(tab.nsrc, dtype=torch.float64, device="cuda", generator=gen) - 0.5
    mode = "min" if label == "min" else None
    out = torch.zeros(tab.n, dtype=torch.float64, device="cuda") if label == "set" else \
        torch.rand(tab.n, dtype=torch.float64, device="cuda", generator=gen) if mode else None
    dst = torch.repeat_interleave(torch.arange(tab.n, device="cuda"),
                                  (tab.ptr[1:] - tab.ptr[:-1]).long())
    sel = tab.sel.long()
    old = earlier_entry(earlier, "dst_scatter", torch.float64) if mode is None else None

    def kern():
        return pck.dst_scatter(tab, src, out=None if out is None else out.clone(), mode=mode)

    def plain():
        return pck.dst_scatter_plain(tab, src, None if out is None else out.clone(), mode)

    def prev():
        return x1_call(old, tab, src, None if out is None else out.clone())

    def lib():
        v = src[sel] if tab.w is None else tab.w * src[sel]
        if mode == "min":
            return out.scatter_reduce(0, dst, v, reduce="amin")
        return torch.zeros(tab.n, dtype=src.dtype, device="cuda").index_add_(0, dst, v)

    # timed in place: set and min modes write the same rows of one scratch
    # copy of out (min: the first call's minimum, the same work after)
    scratch = None if out is None else out.clone()
    timed = (lambda: pck.dst_scatter(tab, src, out=scratch, mode=mode),
             lambda: pck.dst_scatter_plain(tab, src, scratch, mode),
             None if old is None else (lambda: x1_call(old, tab, src, scratch)), lib)
    r = pc_kernel_row("dst_scatter", "float64", kern, plain, lib, x1_bytes(tab, 8),
                      tab.entries * (2 if tab.w is not None else 1), flush, True,
                      "scatter_reduce amin after the gather" if mode else
                      "index_add_ (atomic) after the gather",
                      earlier=None if old is None else prev, timed=timed)
    r.update(mode=label, entries=tab.entries, rows=tab.n, long_destinations=tab.nlong,
             longest_run=int((tab.ptr[1:] - tab.ptr[:-1]).max()))
    if old is not None:
        r["earlier"] = ("earlier_kernels/dst_scatter_thread_per_dst.cu (a thread per "
                        "destination, grid-stride over one wave)")
    return r


def d1_row(label, M, tab, flush, earlier, gen, transposed=False, ybuf=None):
    """D1's row on the table M (f64) with the gather `tab`, into a new
    buffer or accumulated into a copy of ybuf (timed in place on one
    scratch copy): against its plain version to 1e-12, the earlier
    warp-per-row design in turns, torch.bmm on the same padded table after
    the gather as the library call."""
    import torch
    from petsc_tpu_torch.ops import pc_kernels as pck
    x = torch.rand(int(tab.G.max()) + 1, dtype=torch.float64, device="cuda", generator=gen) - 0.5
    acc = ybuf is not None
    old = earlier_entry(earlier, "subdomain_apply", torch.float64)
    scratch = None if ybuf is None else ybuf.clone()

    def calls(fresh):
        def y():
            return None if ybuf is None else (ybuf.clone() if fresh else scratch)
        return (lambda: pck.subdomain_apply(M, tab, x, transposed, y=y(), accumulate=acc),
                lambda: pck.subdomain_apply_plain(M, tab, x, transposed, y(), acc),
                lambda: d1_call(old, M, tab, x, transposed, y(), acc))

    def lib():
        tv = x[tab.G.long()] if tab.w is None else tab.w * x[tab.G.long()]
        return torch.bmm(M.transpose(1, 2) if transposed else M, tv.unsqueeze(-1))

    kern, plain, prev = calls(True)
    k_t, p_t, e_t = calls(False)
    nbytes, real = d1_bytes(M, tab, transposed, acc)
    r = pc_kernel_row("subdomain_apply", "float64", kern, plain, lib, nbytes, 2 * real, flush,
                      False, "torch.bmm on the same padded table, after the gather",
                      earlier=prev, timed=(k_t, p_t, e_t, lib))
    r.update(form="transposed" if transposed else "plain", table=label, shape=list(M.shape),
             real_entries=real, output_map=tab.out is not None, accumulate=acc,
             weighted=tab.w is not None,
             earlier="earlier_kernels/subdomain_warp_per_row.cu (a block per (subdomain, "
                     "64 rows), a warp per row; transposed 32 columns x 8 row groups)")
    return r


def pc_kernel_rows(flush, tabs, earlier):
    """X1 in its three modes, D1 on its four tables and N1 at the path's
    shapes, f64, each beside its earlier design in turns: X1 add on the
    ex59-class MatIS's scatter (the local buffer of 256 x 1,089 to 261,121
    rows), set on config 2's ASM restrict scatter, signed on fetidp's jump
    rows (B); D1 plain on the MatIS's Ab (the 2.43 GB table), on BDDC's
    K_qq^-1 (its output map Qidx, accumulated into Phi xc), on Phi
    (interpolation, C = 4) and transposed on Phi^T (restriction); N1 at
    config 2's length. Library calls: X1 index_add_ (atomic), D1 torch.bmm
    on the same padded tables, N1 none."""
    import torch
    from petsc_tpu_torch.ops import pc_kernels as pck
    g = torch.Generator(device="cuda").manual_seed(21)
    rows = {}
    for label in ("add", "set", "signed"):
        rows[f"dst_scatter_{label}"] = x1_row(label, tabs[f"x1_{label}"], flush, earlier, g)
    M, tab = tabs["d1_ab"]
    rows["subdomain_apply_plain"] = d1_row("Ab", M, tab, flush, earlier, g)
    M, tab, zl = tabs["d1_kqq"]
    rows["subdomain_apply_kqq"] = d1_row("K_qq^-1", M, tab, flush, earlier, g, ybuf=zl)
    M, tab = tabs["d1_phi"]
    rows["subdomain_apply_phi"] = d1_row("Phi", M, tab, flush, earlier, g)
    M, tab = tabs["d1_phi_t"]
    rows["subdomain_apply_transposed"] = d1_row("Phi^T", M, tab, flush, earlier, g,
                                                transposed=True)
    n = tabs["n1"]
    d, y, w = (torch.rand(n, dtype=torch.float64, device="cuda", generator=g) - 0.5
               for _ in range(3))
    r = pc_kernel_row("neumann_step", "float64", lambda: pck.neumann_step(d, y, w),
                      lambda: pck.neumann_step_plain(d, y, w), None, 4 * n * 8, 2 * n, flush,
                      True, "none: no single PyTorch call computes dinv * (y - w)")
    r.update(n=n)
    rows["neumann_step"] = r
    return rows


def nn_long_table(ksp, npad):
    """X1's table of NN's W r (r -> one sum per subdomain, each over its
    1,089 weighted dofs): the long-run shape, from the NN PC's coarse
    restriction table."""
    import numpy as np
    from petsc_tpu_torch.ops import pc_kernels as pck
    ct = ksp.getPC().device_data()["coarse_r"]
    G, D, ks = (t.cpu().numpy() for t in (ct.G, ct.w.double(), ct.nc))
    valid = np.arange(G.shape[1])[None, :] < ks[:, None]
    return pck.scatter_table(np.repeat(np.arange(len(ks)), ks), G[valid], len(ks), npad,
                             D[valid], device="cuda")


def phase_pc(pt, smi, t_start, flush, ex56_op, gmres_ilu_ms, earlier):
    """Phase pc: each case of PC_CASES through the user's entry points, its
    first solve held to the reference's contract with its launches counted
    exactly; the warm time (best of 3), one profiled solve (busy ms and
    share) and the host set-up seconds; then the rows of X1, D1 and N1 on
    the path's tables (pc_kernel_rows, after the MatIS group) and X1's on
    NN's long runs (after NN), each beside the earlier design (`earlier`,
    the earlier designs' library) in turns. Returns (the record, the kernel
    rows, the launches summed over the cases' first solves, the per-case
    launches)."""
    import torch
    contract = pc_contract()
    cases, total, per_case, tabs, rows = {}, {}, {}, {}, {}
    groups = {}
    for case, (group, _) in PC_CASES.items():
        groups.setdefault(group, []).append(case)
    for group, names in groups.items():
        t0 = time.perf_counter()
        op = pc_operator(pt, group, ex56_op)
        torch.cuda.synchronize()
        op_s = time.perf_counter() - t0
        for case in names:
            ksp, b, x, launches, setup_s = pc_solve(pt, case, op)
            got = check_pc(case, ksp, b, x, op[2], contract)
            detail = pc_detail(case, ksp)
            need = exact_pc_launches(case, launches, got["its"], got["reason"], detail)
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            per_case[case] = launches
            ms = warm_ms(ksp, b, x)
            prof = profile_solve(ksp, b, x, ms)
            check_pc(case, ksp, b, x, op[2], contract)
            cases[case] = {**got, "operator_s": op_s, "host_setup_s": setup_s,
                           "warm_ms_best_of_3": ms, "ms_per_it": ms / max(got["its"], 1),
                           "device_busy_ms": prof["device_busy_ms"],
                           "busy_share": prof["busy_share_of_warm"],
                           "spins_seen_before_and_after": prof["spins_seen_before_and_after"],
                           "launches": need, "detail": detail,
                           "by_kernel": prof["by_kernel"][:6],
                           "pc_meta_kind": ksp.getPC().meta[0]}
            if case == "c2_asm":
                tabs["x1_set"] = ksp.getPC().device_data()["scatter"]
            if case == "c2_neumann":
                tabs["n1"] = int(op[2].shape[0])
                cases[case]["gmres_ilu_t1_warm_ms_this_run"] = gmres_ilu_ms
                cases[case]["factor_kinds"] = [ksp.getPC().meta[1][0], ksp.getPC().meta[2][0]]
            if case == "matis_bddc":
                d = ksp.getPC().device_data()
                tabs["d1_phi_t"] = (d["Phi"], d["restrict"])
                tabs["d1_phi"] = (d["Phi"], d["interp"])
                tabs["d1_kqq"] = (d["Kqq_inv"], d["dual"],
                                  torch.zeros(d["Kqq_inv"].shape[:2], dtype=torch.float64,
                                              device="cuda"))
            if case == "matis_fetidp":
                tabs["x1_signed"] = ksp._fetidp[1]["B"]
            if group == "matis" and "d1_ab" not in tabs:
                md = op[0].device_data()
                tabs["d1_ab"] = (md["Ab"], md["d1"])
                tabs["x1_add"] = md["x1"]
            if case == "matis_nn":
                rows["dst_scatter_long"] = x1_row(
                    "long", nn_long_table(ksp, op[0].row_layout.Npad), flush, earlier,
                    torch.Generator(device="cuda").manual_seed(22))
            del ksp, b, x
            torch.cuda.empty_cache()
        if group == "matis":
            rows.update(pc_kernel_rows(flush, tabs, earlier))
            tabs.clear()
        del op
        torch.cuda.empty_cache()
    xp = torch.rand((16, 128), dtype=torch.float32, device="cuda")
    from petsc_tpu_torch.ops import pallas_kernels as pk
    probe_ms = time_ms(lambda: pk.probe(xp), flush)     # the launch floor, this phase
    for r in rows.values():
        r["k1_launch_probe_ms"] = probe_ms
    rec = {"phase": "pc", "nvidia_smi": smi, "cases": cases, "kernel_checks": rows,
           "matis": {"ne_nsub": list(PC_MATIS), "nn_ne_nsub": list(PC_MATIS_NN),
                     "table_GB_each": 256 * 1089 * 1089 * 8 / 1e9},
           "seconds_so_far": time.perf_counter() - t_start}
    return rec, rows, total, per_case



# ---------------------------------------------------------------------
# phase nonlinear: SNES, TS and Tao (item 10)
# ---------------------------------------------------------------------

NONLINEAR_CASES = ("ex5_257", "ex5_1025", "ex19_r3", "ex19_r6", "heat_cn_129", "heat_cn_1025",
                   "heat_rk_adjoint", "tao_lmvm", "tao_nls")
NL_HIST_RTOL = 1e-6        # histories, relative
NL_HIST_FLOOR = 1e-6       # an entry below this fraction of the first ...
NL_HIST_ABS = 1e-12        # ... is held to this fraction of the first
NL_VEC_RTOL = 1e-10        # a vector's 2-norm and its 16 samples
NL_R05 = Path(__file__).resolve().parent / "SNES_TS_r05.json"
EX19_R3_LINE = "  0 SNES Function norm 0.0406612"   # PETSc's ex19_1.out, -da_refine 3
NL_WARM_REPS = 2
NL_ONE_WARM_MS = 5000.0     # a warm run longer than this is not repeated


def nl_profile(run, warm_ms):
    """One run under torch.profiler recording the card's activity alone,
    between spin kernels as profile_solve puts them (its spin count,
    doubled for later profiles, and its re-profile where no spin is seen
    on each side): the card's busy ms (kernels and copies: one stream, no
    overlap), its share of the warm time, and time by kernel, read from
    the raw trace (a long loop's hundreds of thousands of events would
    take minutes through the profiler's own event list)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _attempt in range(3):
        spins_each_side = _SPINS[0]
        nl_sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(spins_each_side):
                torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            for _ in range(WARMUP_SPINS):
                torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        spins, span, by_name = [], [math.inf, -math.inf], {}
        for ev in prof.profiler.kineto_results.events():
            if ev.device_type() != DeviceType.CUDA:
                continue
            name, start, dur = ev.name(), ev.start_ns(), ev.duration_ns()
            if "spin_kernel" in name:
                spins.append(start)
                continue
            span = [min(span[0], start), max(span[1], start + dur)]
            n, d = by_name.get(name, (0, 0))
            by_name[name] = (n + 1, d + dur)
        lead = sum(1 for t in spins if t < span[0])
        trail = sum(1 for t in spins if t > span[1])
        if 2 * lead < spins_each_side:
            _SPINS[0] = 2 * spins_each_side
        if lead and trail:
            break
    else:
        raise AssertionError(f"the profiler kept {lead} of the {spins_each_side} spin kernels "
                             f"before the run and {trail} of {WARMUP_SPINS} after it: it may "
                             "have lost some of the run's own events")
    busy_ms = sum(d for _, d in by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "busy_share_of_warm": busy_ms / warm_ms if by_name else None,
            "spins_seen_before_and_after": [lead, trail], "spins_before": spins_each_side,
            "device_events": sum(n for n, _ in by_name.values()),
            "by_kernel": [{"name": k[:90], "count": n, "ms": d / 1e6} for k, (n, d) in top]}


def snes_contract():
    return json.loads((DATA / "snes_contract.json").read_text())


def r05_records():
    """SNES_TS_r05.json's lines by artifact (the reference's counts and
    norms; its times are the TPU's and are not used)."""
    out = {}
    for line in NL_R05.read_text().splitlines():
        if line.strip():
            r = json.loads(line)
            out[r["artifact"]] = r
    return out


def nl_hist_check(label, got, want):
    """Lengths equal; each entry to NL_HIST_RTOL relative, one below
    NL_HIST_FLOOR of the first to NL_HIST_ABS of the first. Returns the
    largest relative error of the entries held relatively."""
    got, want = [float(v) for v in got], [float(v) for v in want]
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} entries, want {len(want)}: {got} vs {want}")
    scale = abs(want[0]) if want else 1.0
    worst = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        if abs(w) < NL_HIST_FLOOR * scale:
            ok = abs(g - w) <= NL_HIST_ABS * scale
        else:
            ok = abs(g - w) <= NL_HIST_RTOL * abs(w)
            worst = max(worst, abs(g - w) / abs(w))
        if not ok:
            raise AssertionError(f"{label}: entry {k} is {g!r}, want {w!r}")
    return worst


def nl_vec_check(label, v, want):
    """A vector's 2-norm and its samples (the contract's sample_idx) to
    NL_VEC_RTOL relative of the contract's."""
    import numpy as np
    v = v.detach().double().cpu().numpy()
    norm = float(np.linalg.norm(v))
    ws = np.asarray(want["sample"])
    nerr = abs(norm - want["norm2"]) / abs(want["norm2"])
    serr = float(np.abs(v[np.asarray(want["sample_idx"])] - ws).max()
                 / max(float(np.abs(ws).max()), 1e-300))
    if not (nerr <= NL_VEC_RTOL and serr <= NL_VEC_RTOL):
        raise AssertionError(f"{label}: 2-norm {norm!r} (want {want['norm2']!r}, rel err "
                             f"{nerr:.3g}), samples' rel err {serr:.3g}, limit {NL_VEC_RTOL}")
    return {"norm2": norm, "norm_rel_err": nerr, "samples_rel_err": serr}


def nonlinear_launches_needed(kind, r):
    """The launches of one run of a phase nonlinear case, from what the
    run reports it did (r: the case's result). The loops' vector steps:

    - newtonls with the bt line search (ex5, ex19): ||F(x0)|| (one K4);
      each line-search trial x - lam y (K2) and its residual's norm (K4),
      r["ls_its"] the trials of each Newton step; then ||y|| and ||x|| (two
      K4) a step.
    - heat_cn: each time step one JFNK stage solve (snes/compiled.py):
      ||F(x0)||; a Newton step one GMRES(m) cycle, ||b|| and V0 = b / ||b||
      (K4, K2) and two fused Gram-Schmidt updates a Krylov vector (2m K3),
      then each backtracking trial x - lam s and its norm (K2, K4);
      r["snes_its"] and r["ls_its"] sum them over the steps.
    - heat_rk_adjoint: each step of the tableau, one K2 a nonzero of A's
      strictly lower part, of b and of b - bhat (the error estimate); the
      adjoint replay is autograd over plain arithmetic.
    - tao: each Wolfe search (r["ls_its"]: a descent direction, trials,
      curvature tests) <g, d> (K4), then a trial point x + t d a trial and
      the accepted (or last) point (K2), a curvature test <g_t, d> (K4);
      lmvm: each direction the two-loop recursion over p pairs (3p K4 and
      2p K2, with the scaling's two K4 and one K2 where p > 0) and <d, g>;
      each accepted step s, y (two K2), <s, y> and ||g|| (two K4); ||g0||.
      nls: each Newton-CG solve (r["cg_its"]: Hessian products h, ended by
      negative curvature e) ||r0||^2, h curvatures <p, Hp> and, for each
      product not ending it, three K2 and one K4; then <d, g>; ||g|| a step
      and ||g0||.

    The linear solves add, per Newton step: ex5, setValuesCOO's two K8
    (v[perm] and the diagonal) and grid_launches_needed(its, levels), CG +
    GAMG with the structured head, set-up included (the pmat's values
    change every step, so GAMG sets up again); ex19, the FD pmat's
    setValuesCOO (two K8) and GMRES(30) + ILU(0) on the matrix-free
    Jacobian (a jvp: no kernel): one K3 a Krylov vector and two T1 sweeps
    per PC application (its + cycles). User functions and autograd are
    PyTorch and launch none of the port's kernels."""
    need = {}

    def add(k, v):
        if v:
            need[k] = need.get(k, 0) + v

    if kind in ("ex5", "ex19"):
        trials = sum(r["ls_its"])
        add("triad", trials)
        add("dot2", 1 + trials + 2 * r["its"])
        for its in r["ksp_its"]:
            add("gather", 2)
            if kind == "ex5":
                for k, v in grid_launches_needed(its, r["_levels"], probes=9).items():
                    add(k, v)
            else:
                add("axpy_normsq", its)
                add("trisolve", 2 * (its + max(1, math.ceil(its / 30))))
    elif kind == "heat_cn":
        from petsc_tpu_torch.snes.compiled import GMRES_M
        its, trials = r["snes_its"], sum(r["ls_its"])
        add("dot2", r["steps"] + its + trials)
        add("triad", its + trials)
        add("axpy_normsq", 2 * GMRES_M * its)
    elif kind == "heat_rk_adjoint":
        A, b, bhat = r["tableau"]
        per_step = (sum(A[i][j] != 0.0 for i in range(len(b)) for j in range(i))
                    + sum(bi != 0.0 for bi in b)
                    + (sum(bi - bh != 0.0 for bi, bh in zip(b, bhat)) if bhat else 0))
        add("triad", r["steps"] * per_step)
    elif kind == "tao":
        for descent, trials, tests in r["ls_its"]:
            add("dot2", 1 + tests)
            if descent:
                add("triad", trials + 1)
        for p in r["lbfgs_pairs"]:
            add("dot2", 3 * p + 2 * (p > 0) + 1)
            add("triad", 2 * p + (p > 0))
        for h, negative in r["cg_its"]:
            add("dot2", 1 + 2 * h - negative + 1)
            add("triad", 3 * (h - negative))
        add("dot2", 1 + r["its"] * (2 if r["type"] == "lmvm" else 1))
        if r["type"] == "lmvm":
            add("triad", 2 * r["its"])
    return need


def nl_ex5(pt, c):
    """PETSc's ex5 through petsc_tpu_torch/examples/ex5.py's residual,
    Jacobian callback and initial guess, as snes_contract.py runs the
    reference's (examples/snes_ts_probe.py's bratu_block): CG + GAMG,
    KSP rtol 1e-5, max_it 200."""
    import torch
    from petsc_tpu_torch.examples import ex5
    n, lam = c["n"], c["par"]
    da = pt.DMDA.create(2, (n, n), dof=1, stencil_width=1)
    snes = pt.SNES().create()
    snes.setDM(da)
    snes.setFunction(ex5.make_residual(da, lam))
    J = da.createMatrix()
    snes.setJacobian(ex5.make_jacobian(da, lam), J=J)
    ksp = snes.getKSP()
    ksp.setType("cg")
    ksp.getPC().setType("gamg")
    ksp.setTolerances(rtol=c["ksp_rtol"], max_it=c["ksp_max_it"])
    coo = {"setPreallocationCOO": [], "setValuesCOO": []}
    for name in coo:
        def timed(*a, _f=getattr(J, name), _k=name):
            nl_sync()
            t0 = time.perf_counter()
            r = _f(*a)
            nl_sync()
            coo[_k].append(time.perf_counter() - t0)
            return r
        setattr(J, name, timed)
    guess = torch.as_tensor(ex5.initial_guess(da, lam), dtype=torch.float64,
                            device=pt.config.device())

    def run():
        x = da.createGlobalVector()
        x.array = guess.clone()
        snes.solve(None, x)
        return x

    def result(x):
        levels = ksp.getPC()._impl.levels
        return {"its": snes.getIterationNumber(), "reason": int(snes.getConvergedReason()),
                "history": [float(h) for h in snes.getConvergenceHistory()],
                "ksp_its": list(snes._ksp_its), "ls_its": list(snes._ls_its),
                "gamg_levels": [int(lev.A.getSize()[0]) for lev in levels],
                "level_kinds": [lev.A.meta[0] for lev in levels],
                "x": x.array, "_levels": levels}
    return run, result, coo


def nl_ex19(pt, c):
    """PETSc's ex19 through petsc_tpu_torch/examples/ex19.py's residual and
    initial guess, set up as its main() does: a 4 x 4 dof-4 DMDA refined
    c["refine"] times, setUseMF, the SNES's own defaults (GMRES(30) +
    ILU(0) on the FD-colouring pmat)."""
    import torch
    from petsc_tpu_torch.examples import ex19
    da = pt.DMDA.create(dim=2, sizes=(4, 4), dof=4, stencil_type="star")
    for _ in range(c["refine"]):
        da = da.refine()
    mx, my = da.sizes
    snes = pt.SNES().create()
    snes.setDM(da)
    snes.setFunction(ex19.make_residual(mx, my, 1.0 / (mx * my), 1.0, 1.0))
    snes.setUseMF(True)
    snes.setFromOptions()
    guess = torch.as_tensor(ex19.initial_guess(mx, my, 1.0), dtype=torch.float64,
                            device=pt.config.device())

    def run():
        x = pt.Vec.from_array(guess)
        snes.solve(None, x)
        return x

    def result(x):
        P = snes._fd_coloring["mat"]
        return {"mx": mx, "my": my, "its": snes.getIterationNumber(),
                "reason": int(snes.getConvergedReason()),
                "history": [float(h) for h in snes.getConvergenceHistory()],
                "monitor_line": f"{0:3d} SNES Function norm {snes.getConvergenceHistory()[0]:g}",
                "ksp_its": list(snes._ksp_its), "ls_its": list(snes._ls_its),
                "ncolors": snes._fd_coloring["ncolors"],
                "pmat_kind": P.meta[0], "pmat_nnz": P.nnz(), "x": x.array}
    return run, result, None


def nl_heat_u0(n):
    """sin(pi x) sin(pi y) on the n x n grid, x fastest (snes_contract.py's
    heat_u0: x = i hx)."""
    import numpy as np
    yi, xi = np.divmod(np.arange(n * n), n)
    h = 1.0 / (n - 1)
    return np.sin(np.pi * xi * h) * np.sin(np.pi * yi * h)


def nl_heat(pt, c, adjoint):
    """The heat equation through petsc_tpu_torch/examples/heat.py's RHS:
    Crank-Nicolson with the device-loop JFNK stage solve
    (ts.use_compiled_snes), dt = hx^2 (examples/snes_ts_probe.py's
    ts_heat_block), or rk 3bs at dt = 0.2 hx^2 with a saved trajectory and
    adjointSolve(dJdu = u_T)."""
    import torch
    from petsc_tpu_torch.examples import heat
    n = c["n"]
    da = pt.DMDA.create(2, (n, n), dof=1, stencil_width=1)
    hx = 1.0 / (n - 1)
    ts = pt.TS().create()
    if adjoint:
        ts.setType("rk")
        ts.setRKType(c["rk_type"])
        ts.adapt.kind = "none"
        dt = c["dt_factor"] * hx * hx
    else:
        ts.setType("cn")
        ts.use_compiled_snes = True
        dt = hx * hx
    ts.setRHSFunction(heat.make_rhs(da))
    ts.setTimeStep(dt)
    ts.setMaxSteps(c["steps"])
    ts.setMaxTime(1e9)
    u0_np = nl_heat_u0(n)
    u0 = torch.as_tensor(u0_np, dtype=torch.float64, device=pt.config.device())

    def run():
        ts.setTime(0.0)
        if adjoint:
            ts.setSaveTrajectory()
        u = pt.Vec.from_array(u0)
        ts.solve(u)
        lam = ts.adjointSolve(u.array, u0).array if adjoint else None
        return u, lam

    def result(out):
        u, lam = out
        uT = u.array
        tend = ts.getTime()
        err = float((uT - u0 * math.exp(-2 * math.pi ** 2 * tend)).abs().max())
        rec = {"dt": dt, "steps": ts.getStepNumber(), "reason": int(ts.getConvergedReason()),
               "t_end": tend, "max_err_vs_analytic": err, "u": uT, "lambda0": lam,
               "snes_its": ts.getSNESIterations(), "ls_its": list(ts._ls_its)}
        if adjoint:
            from petsc_tpu_torch.ts.ts import _RK_TABLES
            rec["tableau"] = _RK_TABLES[c["rk_type"]][:3]
        return rec
    return run, result, None


def nl_rosenbrock(x):
    import torch
    return torch.sum(100.0 * (x[1::2] - x[0::2] ** 2) ** 2 + (1.0 - x[0::2]) ** 2)


def nl_tao(pt, c):
    """Tao lmvm or nls on the chained Rosenbrock of tests/test_tao.py
    (rosenbrock1.c's form) at n = 2^log2n from x = 0."""
    import torch
    n = 2 ** c["log2n"]
    tao = pt.Tao().create()
    tao.setType(c["type"])
    tao.setObjective(nl_rosenbrock)

    def run():
        x = pt.Vec.from_array(torch.zeros(n, dtype=torch.float64, device=pt.config.device()))
        tao.solve(x)
        return x

    def result(x):
        return {"its": tao.getIterationNumber(), "reason": int(tao.getConvergedReason()),
                "type": c["type"], "ls_its": [tuple(e) for e in tao._ls_its],
                "lbfgs_pairs": list(tao._lbfgs_pairs), "cg_its": list(tao._cg_its),
                "f_history": [f for f, _ in tao._history],
                "g_history": [g for _, g in tao._history], "x": x.array}
    return run, result, None


def nl_check(case, c, r, r05):
    """The first run against the contract (and SNES_TS_r05.json); returns
    the record's check entries."""
    kind = c["kind"]
    out = {}
    if kind in ("ex5", "ex19", "tao"):
        if (r["its"], r["reason"]) != (c["its"], c["reason"]):
            raise AssertionError(f"{case}: its {r['its']}, reason {r['reason']}; the contract "
                                 f"{c['its']}, {c['reason']}")
    if kind in ("ex5", "ex19"):
        out["history_worst_rel"] = nl_hist_check(case, r["history"], c["history"])
    if kind == "ex5":
        if r["gamg_levels"] != c["gamg_levels"]:
            raise AssertionError(f"{case}: GAMG levels {r['gamg_levels']}, the reference's "
                                 f"{c['gamg_levels']}")
        if case == "ex5_257":
            ref = r05["snes_bratu_ex5"]
            if (r["its"], r["reason"]) != (ref["newton_its"], ref["reason"]):
                raise AssertionError(f"{case}: not SNES_TS_r05.json's its and reason")
            out["r05_history_worst_rel"] = nl_hist_check(f"{case} vs r05", r["history"],
                                                         ref["fnorm_history"])
    if kind == "ex19" and case == "ex19_r3" and r["monitor_line"] != EX19_R3_LINE:
        raise AssertionError(f"{case}: monitor line {r['monitor_line']!r}, want "
                             f"{EX19_R3_LINE!r}")
    if kind == "tao":
        out["f_history_worst_rel"] = nl_hist_check(f"{case} f", r["f_history"],
                                                   c["f_history"])
        out["g_history_worst_rel"] = nl_hist_check(f"{case} |g|", r["g_history"],
                                                   c["g_history"])
    if kind in ("heat_cn", "heat_rk_adjoint"):
        if r["steps"] != c["steps_taken"] or r["t_end"] != c["t_end"]:
            raise AssertionError(f"{case}: {r['steps']} steps to t = {r['t_end']!r}; the "
                                 f"contract {c['steps_taken']} to {c['t_end']!r}")
        out["u"] = nl_vec_check(f"{case} u", r["u"], c["u"])
    if kind == "heat_cn":
        out["max_err_rel"] = nl_hist_check(f"{case} max error", [r["max_err_vs_analytic"]],
                                           [c["max_err_vs_analytic"]])
        if case == "heat_cn_129":
            ref = r05["ts_heat_cn"]
            if r["t_end"] != ref["t_end"]:
                raise AssertionError(f"{case}: t_end {r['t_end']!r}, r05 {ref['t_end']!r}")
            out["r05_max_err_rel"] = nl_hist_check(f"{case} vs r05", [r["max_err_vs_analytic"]],
                                                   [ref["max_err_vs_analytic"]])
    if kind == "heat_rk_adjoint":
        out["lambda0"] = nl_vec_check(f"{case} lambda0", r["lambda0"], c["lambda0"])
    return out


def nl_sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def nl_build(pt, case, c):
    """(run, result, coo) of a case (nl_ex5, nl_ex19, nl_heat, nl_tao), after
    init() on the package's device (the card unless the caller's init chose
    the CPU)."""
    kind = c["kind"]
    if kind == "ex5":
        return nl_ex5(pt, c)
    if kind == "ex19":
        return nl_ex19(pt, c)
    if kind == "tao":
        return nl_tao(pt, c)
    return nl_heat(pt, c, adjoint=kind == "heat_rk_adjoint")


def nl_first(pt, case, c, run, result, needed=None):
    """The case's first run with every launch count set to 0 just before
    and read just after, held exactly to needed(kind, result)
    (nonlinear_launches_needed by default): (result, launches, the
    profiler's events, seconds)."""
    nl_sync()
    pt.log().reset()
    reset_launches()
    t0 = time.perf_counter()
    out = run()
    nl_sync()
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in launch_counts().items() if v}
    events = set_up_events(pt)
    r = result(out)
    need = (needed or nonlinear_launches_needed)(c["kind"], r)
    if launches != need:
        bad = {k: (launches.get(k, 0), need.get(k, 0)) for k in set(launches) | set(need)
               if launches.get(k, 0) != need.get(k, 0)}
        raise AssertionError(f"{case}: launches (got, want): {bad}")
    return r, launches, events, seconds


def nl_case(pt, case, c, r05):
    """One case: its first run (nl_first) checked against the contract;
    the host set-up split from the profiler's events; the best of
    NL_WARM_REPS warm runs (one where it takes over NL_ONE_WARM_MS); one
    profiled run (nl_profile)."""
    pt.init(args=[])
    run, result, coo = nl_build(pt, case, c)
    r, launches, events, first_s = nl_first(pt, case, c, run, result)
    checks = nl_check(case, c, r, r05)
    warm = math.inf
    for _ in range(NL_WARM_REPS):
        nl_sync()
        t0 = time.perf_counter()
        run()
        nl_sync()
        warm = min(warm, (time.perf_counter() - t0) * 1e3)
        if warm > NL_ONE_WARM_MS:
            break
    prof = nl_profile(run, warm)
    rec = {"case": case, "kind": c["kind"], "first_s": first_s, "warm_ms": warm,
           "busy_ms": prof["device_busy_ms"], "busy_share": prof["busy_share_of_warm"],
           "device_events": prof["device_events"], "profiled_wall_ms": prof["profiled_wall_ms"],
           "spins_seen_before_and_after": prof["spins_seen_before_and_after"],
           "by_kernel": prof["by_kernel"], "launches": launches,
           "checks": checks,
           "setup_s": {"jacobian": events.get("SNESJacobianEval", 0.0),
                       "pcsetup": sum(v for k, v in events.items() if k.startswith("PCSetUp")),
                       "coloring": events.get("SNESFDColorSetUp", 0.0),
                       "ksp_solve": events.get("KSPSolve", 0.0),
                       "snes_solve": events.get("SNESSolve", 0.0),
                       "ts_solve": events.get("TSSolve", 0.0)},
           "events": events}
    for k in ("its", "reason", "ksp_its", "gamg_levels", "level_kinds", "ncolors", "pmat_kind",
              "pmat_nnz", "steps", "t_end", "max_err_vs_analytic", "dt", "mx", "my",
              "monitor_line", "history", "f_history", "g_history", "snes_its", "ls_its",
              "lbfgs_pairs", "cg_its"):
        if k in r:
            rec[k] = r[k]
    if c["kind"] == "ex5":
        rec["contract_ksp_its"] = c["ksp_its"]
    if coo is not None:
        rec["coo_s"] = coo
    return rec, launches


def phase_nonlinear(pt, smi, t_start):
    """Every case of NONLINEAR_CASES (nl_case); returns (the phase's record,
    {case: launches})."""
    import torch
    contract = snes_contract()
    r05 = r05_records()
    cases, by_case = [], {}
    for case in NONLINEAR_CASES:
        t0 = time.perf_counter()
        rec, launches = nl_case(pt, case, contract[case], r05)
        rec["seconds"] = time.perf_counter() - t0
        cases.append(rec)
        by_case[case] = launches
        torch.cuda.empty_cache()
    return {"phase": "nonlinear", "nvidia_smi": smi, "cases": cases,
            "elapsed_s": time.perf_counter() - t_start}, by_case


# ---------------------------------------------------------------------
# phase plex: DMPlex, PetscFE/DS and FV on Plex (item 11, first half)
# ---------------------------------------------------------------------

PLEX_CASES = ("ex12_p2_256", "ex12_p2_64", "plex_mg_1025", "fvplex_advect_724")
PLEX_U_RTOL = 1e-8         # ex12's u and nodal error, the MG solution: relative
PLEX_FV_TOL = 1e-10        # FV's u: of max|u|
# phase plex's X1 rows: the DS residual's add table (ex12_p2_256), the FV
# face fluxes' signed table and the limiter's min table (fvplex_advect_724)
PLEX_X1_TABLES = (("ex12_p2_256", "add"), ("fvplex_advect_724", "signed"),
                  ("fvplex_advect_724", "min"))


def plex_contract():
    return json.loads((DATA / "plex_contract.json").read_text())


def plex_vec_check(label, v, want, tol, of_max=False):
    """A vector's 2-norm to `tol` relative, and its samples (the contract's
    sample_idx) to `tol` relative of their largest, or with of_max each
    sample and the min and max to `tol` of the contract's max|u| (an
    entrywise bound: the norm, a sum over a million entries, is held
    relative to itself)."""
    import numpy as np
    v = v.detach().double().cpu().numpy()
    ws = np.asarray(want["sample"])
    scale = max(abs(want["max"]), abs(want["min"])) if of_max else None
    got = {"norm2": float(np.linalg.norm(v)), "min": float(v.min()), "max": float(v.max())}
    errs = {"norm2": abs(got["norm2"] - want["norm2"]) / abs(want["norm2"]),
            "samples": float(np.abs(v[np.asarray(want["sample_idx"])] - ws).max()
                             / (scale or max(float(np.abs(ws).max()), 1e-300)))}
    if of_max:
        errs.update(min=abs(got["min"] - want["min"]) / scale,
                    max=abs(got["max"] - want["max"]) / scale)
    bad = {k: e for k, e in errs.items() if not e <= tol}
    if bad:
        raise AssertionError(f"{label}: {got} against {want['norm2']!r} / {want['min']!r} / "
                             f"{want['max']!r}: errors {bad} above {tol}")
    return {**got, "errors": errs}


def plex_ex12(pt, c):
    """PETSc's ex12 through petsc_tpu_torch/examples/ex12.py's Ex12 (the
    box mesh, the P2 DS, the SNES with its callbacks), with the case's
    options; run() is Newton from zero."""
    from petsc_tpu_torch.examples import ex12
    pt.init(args=["-fe_order", str(c["order"]), "-faces", str(c["faces"]), *c["args"]])
    prob = ex12.Ex12(c["order"], c["faces"])
    snes = prob.snes

    def result(x):
        ksp = snes.getKSP()
        impl = ksp.getPC()._impl
        levels = getattr(impl, "levels", None)
        return {"its": snes.getIterationNumber(), "reason": int(snes.getConvergedReason()),
                "history": [float(h) for h in snes.getConvergenceHistory()],
                "ksp_its": list(snes._ksp_its), "ls_its": list(snes._ls_its),
                "ksp_type": ksp.getType(), "pc_type": ksp.getPC().getType(),
                "max_err": prob.nodal_error(x), "ndof": prob.n, "x": x.array,
                "gamg_levels": [int(lev.A.getSize()[0]) for lev in levels] if levels else None,
                "_nlev": len(levels) if levels else None}
    return prob.solve, result, prob


def plex_mg(pt, c):
    """assemblePoissonP1 on createBoxMesh((faces, faces)) refined c["refine"]
    times, CG + PCMG with -pc_mg_levels from the plex's refinement chain
    (Galerkin coarse operators, the recorded interpolations); run() solves
    from zero."""
    pt.init(args=["-pc_mg_levels", str(c["levels"])])
    secs = {}
    t = time.perf_counter()
    plex = pt.DMPlex.createBoxMesh((c["faces"], c["faces"]), simplex=True)
    secs["mesh"] = time.perf_counter() - t
    t = time.perf_counter()
    for _ in range(c["refine"]):
        plex = plex.refine()
    secs["refine"] = time.perf_counter() - t
    t = time.perf_counter()
    A, b = plex.assemblePoissonP1(f=1.0)
    nl_sync()
    secs["assemble"] = time.perf_counter() - t
    ksp = pt.KSP().create()
    ksp.setOperators(A)
    ksp.setType("cg")
    ksp.getPC().setType("mg")
    ksp.getPC().setFromOptions()
    ksp.setTolerances(rtol=c["rtol"], max_it=c["max_it"])

    def run():
        x = A.createVecRight()
        ksp.solve(b, x)
        return x

    def result(x):
        levels = ksp.getPC()._impl.levels
        return {"its": ksp.getIterationNumber(), "reason": int(ksp.getConvergedReason()),
                "history": [float(h) for h in ksp.getConvergenceHistory()],
                "mg_levels": [int(lev.A.getSize()[0]) for lev in levels],
                "_nlev": len(levels), "x": x.array}
    return run, result, SimpleNamespace(A=A, b=b, seconds=secs)


def plex_fv(pt, c):
    """FVPlex (upwind, order 2, Barth-Jespersen) on createBoxMesh((faces,
    faces)); run() advects plex_contract.py's bump (tests/test_fv_plex.py's
    _advect) by SSP-RK2 to T."""
    import numpy as np
    import torch
    from petsc_tpu_torch.dm.fv_plex import FVPlex, face_geometry
    pt.init(args=[])
    secs = {}
    t = time.perf_counter()
    mesh = pt.DMPlex.createBoxMesh((c["faces"], c["faces"]), simplex=True)
    secs["mesh"] = time.perf_counter() - t
    t = time.perf_counter()
    face_geometry(mesh)
    secs["face_geometry"] = time.perf_counter() - t
    vx, vy = c["vel"]

    def flux(u):
        return (vx * u, vy * u)

    def wavespeed(uL, uR, n):
        return vx * n[:, 0] + vy * n[:, 1]

    t = time.perf_counter()
    fv = FVPlex(mesh, flux, wavespeed, riemann="upwind", bc="outflow", order=c["order"],
                limiter=c["limiter"])
    secs["fvplex_init"] = time.perf_counter() - t
    secs["ls_tables"] = secs["fvplex_init"] - secs["face_geometry"]
    rhs = fv.makeRHS()
    g = fv.geom
    cc = g["ccent"]
    u0 = torch.as_tensor(np.exp(-((cc[:, 0] - 0.3) ** 2 + (cc[:, 1] - 0.3) ** 2) / 0.02),
                         dtype=torch.float64, device=pt.config.device())
    h = float(np.sqrt(g["vol"].min()))
    nst = int(np.ceil(c["T"] / (c["cfl"] * h / np.hypot(vx, vy))))
    dt = c["T"] / nst

    def run():
        u = u0.clone()
        for _ in range(nst):
            u1 = u + dt * rhs(0.0, u)
            u = 0.5 * (u + u1 + dt * rhs(0.0, u1))
        return u

    def result(u):
        return {"steps": nst, "dt": dt, "ncells": mesh.ncells, "nfaces": len(g["cL"]),
                "x": u}
    return run, result, SimpleNamespace(fv=fv, seconds=secs)


def plex_launches_needed(kind, r):
    """The launches of one run of a phase plex case, from what the run
    reports it did (r: the case's result).

    - ex12: each residual (F(x0), then each line-search trial) one K8 (u[conn])
      and one X1 add (the element residuals into F); each Jacobian (one a
      Newton step) one K8 (u[conn]), one X1 add (the element Jacobians and the
      identity's 1.0 into the CSR slots) and setValuesCOO's two K8 (v[perm],
      the diagonal); the Newton loop's K2/K4 as ex5's (one K4 for ||F(x0)||,
      a K2 and a K4 a trial, two K4 a step). Each linear solve, GMRES(30)
      from zero with k iterations in c = ceil(k / 30) cycles: one S2 a step
      and at each later cycle's start, one K3 a step, and k + c PC
      applications: ILU(0) two T1 sweeps each; GAMG one V-cycle each
      (_mg_apply_launches; its set-up, again each Newton step, is host work
      on the downloaded values and launches nothing).
    - plex_mg: mg_launches_needed(its, levels), the set-up's device work
      being host Galerkin products and host eigen bounds (no launch).
    - fvplex: each SSP-RK2 step two right-hand sides, each eleven K8 (u at
      the left and right cells, the least-squares stencil u[nb], the
      gradient at each side, the envelope's min and max at each side, the
      limiter at each side) and two X1 (the limiter's min, the fluxes'
      signed scatter)."""
    need = {}

    def add(k, v):
        if v:
            need[k] = need.get(k, 0) + v

    if kind == "ex12":
        trials = sum(r["ls_its"])
        its = r["its"]
        add("gather", 1 + trials + 3 * its)
        add("dst_scatter", 1 + trials + its)
        add("triad", trials)
        add("dot2", 1 + trials + 2 * its)
        for k in r["ksp_its"]:
            cycles = max(1, math.ceil(k / 30))
            add("csr_spmv", k + cycles - 1)
            add("axpy_normsq", k)
            if r["pc_type"] == "ilu":
                add("trisolve", 2 * (k + cycles))
            else:
                for kk, v in _mg_apply_launches(r["_nlev"]).items():
                    add(kk, v * (k + cycles))
    elif kind == "plex_mg":
        for k, v in mg_launches_needed(r["its"], r["_nlev"]).items():
            add(k, v)
    elif kind == "fvplex":
        add("gather", 22 * r["steps"])
        add("dst_scatter", 4 * r["steps"])
    return need


def plex_check(case, c, r):
    """The first run against the contract; returns the record's check entries."""
    out = {}
    kind = c["kind"]
    if kind in ("ex12", "plex_mg"):
        if (r["its"], r["reason"]) != (c["its"], c["reason"]):
            raise AssertionError(f"{case}: its {r['its']}, reason {r['reason']}; the contract "
                                 f"{c['its']}, {c['reason']}")
        if "spread" in c:
            out.update(plex_spread_check(case, r, c))
        else:
            out["history_worst_rel"] = nl_hist_check(case, r["history"], c["history"])
    if kind == "ex12":
        if "spread" not in c and r["ksp_its"] != c["ksp_its"]:
            raise AssertionError(f"{case}: inner its {r['ksp_its']}, the contract's "
                                 f"{c['ksp_its']}")
        if (r["ksp_type"], r["pc_type"]) != (c["ksp_type"], c["pc_type"]):
            raise AssertionError(f"{case}: {r['ksp_type']} + {r['pc_type']}, the contract's "
                                 f"{c['ksp_type']} + {c['pc_type']}")
        err_rel = abs(r["max_err"] - c["max_err"]) / abs(c["max_err"])
        # a spread the reference's own runs show is held to twice its size
        tol = max([PLEX_U_RTOL] + [2 * abs(e - c["max_err"]) / abs(c["max_err"])
                                   for e in c.get("spread", {}).get("max_err", [])])
        if not err_rel <= tol:
            raise AssertionError(f"{case}: max nodal error {r['max_err']!r}, the contract's "
                                 f"{c['max_err']!r} (rel {err_rel:.3g}, limit {tol:.3g})")
        out["max_err_rel"] = err_rel
        out["max_err_held_within_rel"] = tol
        out["u"] = plex_vec_check(f"{case} u", r["x"], c["u"], PLEX_U_RTOL)
    if kind == "plex_mg":
        if r["mg_levels"] != c["mg_levels"]:
            raise AssertionError(f"{case}: levels {r['mg_levels']}, the contract's "
                                 f"{c['mg_levels']}")
        out["x"] = plex_vec_check(f"{case} x", r["x"], c["x"], PLEX_U_RTOL)
    if kind == "fvplex":
        if r["steps"] != c["steps"] or r["dt"] != c["dt"]:
            raise AssertionError(f"{case}: {r['steps']} steps of {r['dt']!r}, the contract's "
                                 f"{c['steps']} of {c['dt']!r}")
        out["u"] = plex_vec_check(f"{case} u", r["x"], c["u"], PLEX_FV_TOL, of_max=True)
    return out


def plex_spread_check(case, r, c):
    """A case whose reference parts from itself under rounding (the
    contract's "spread": its runs with the residual or the Jacobian
    perturbed at rounding level, plex_contract.py --spread): each inner
    count and history entry on which those runs agree with the contract is
    held as nl_hist_check holds it (counts equal); one on which they part,
    to twice their largest distance from the contract (plex_check holds
    the nodal error so too). Returns the check entries."""
    sp = c["spread"]
    if len(r["ksp_its"]) != len(c["ksp_its"]):
        raise AssertionError(f"{case}: {len(r['ksp_its'])} linear solves, the contract's "
                             f"{len(c['ksp_its'])}")
    held = []
    for k, (g, w) in enumerate(zip(r["ksp_its"], c["ksp_its"])):
        d = max(abs(run[k] - w) for run in sp["ksp_its"])
        if abs(g - w) > 2 * d:
            raise AssertionError(f"{case}: inner its {r['ksp_its']}, the contract's "
                                 f"{c['ksp_its']}; step {k} may differ by {2 * d}")
        held.append(2 * d)
    got, want = [float(v) for v in r["history"]], [float(v) for v in c["history"]]
    if len(got) != len(want):
        raise AssertionError(f"{case}: {len(got)} history entries, want {len(want)}")
    scale = abs(want[0])
    tols = []
    for k, (g, w) in enumerate(zip(got, want)):
        d = max(abs(run[k] - w) for run in sp["history"])
        tol = max(NL_HIST_ABS * scale if abs(w) < NL_HIST_FLOOR * scale
                  else NL_HIST_RTOL * abs(w), 2 * d)
        if not abs(g - w) <= tol:
            raise AssertionError(f"{case}: history entry {k} is {g!r}, want {w!r} within "
                                 f"{tol!r} (twice the reference's spread {d!r})")
        tols.append(tol)
    return {"ksp_its_held_within": held, "history_held_within": tols,
            "history_rel": [abs(g - w) / abs(w) for g, w in zip(got, want)]}


def plex_first(pt, case, c, run, result):
    """nl_first held to plex_launches_needed."""
    return nl_first(pt, case, c, run, result, needed=plex_launches_needed)


def plex_build(pt, c):
    return {"ex12": plex_ex12, "plex_mg": plex_mg, "fvplex": plex_fv}[c["kind"]](pt, c)


def plex_true_relres(ctx, x):
    """||b - A x|| / ||b|| in scipy on the host (after the counted run)."""
    import numpy as np
    A = ctx.A.to_scipy()
    xv = x.getArray()[: A.shape[0]]
    bv = ctx.b.getArray()[: A.shape[0]]
    return float(np.linalg.norm(A @ xv - bv) / np.linalg.norm(bv))


def plex_case(pt, case, c, flush):
    """One case: its first run (plex_first) checked against the contract;
    the host seconds by part; the best of NL_WARM_REPS warm runs (one where
    a run takes over NL_ONE_WARM_MS); one profiled run (nl_profile). Returns
    (record, launches, X1 tables of the case for plex_x1_rows)."""
    t0 = time.perf_counter()
    run, result, ctx = plex_build(pt, c)
    build_s = time.perf_counter() - t0
    r, launches, events, first_s = plex_first(pt, case, c, run, result)
    checks = plex_check(case, c, r)
    rec = {"case": case, "kind": c["kind"], "build_s": build_s, "first_s": first_s}
    if c["kind"] == "plex_mg":
        x = pt.Vec.from_array(r["x"])
        rel = plex_true_relres(ctx, x)
        if not rel <= 10 * c["true_relres"]:
            raise AssertionError(f"{case}: true relres {rel!r}, the contract's "
                                 f"{c['true_relres']!r}")
        checks["true_relres"] = rel
    warm = math.inf
    for _ in range(NL_WARM_REPS):
        nl_sync()
        t1 = time.perf_counter()
        run()
        nl_sync()
        warm = min(warm, (time.perf_counter() - t1) * 1e3)
        if warm > NL_ONE_WARM_MS:
            break
    prof = nl_profile(run, warm)
    host = dict(ctx.seconds)
    # PCSetUp_<type> holds its parts (PCMGSetUp_*, PCGAMGSetUp_*: in the record's events)
    host["pcsetup"] = sum(v for k, v in events.items() if k.startswith("PCSetUp"))
    rec.update(warm_ms=warm, busy_ms=prof["device_busy_ms"],
               busy_share=prof["busy_share_of_warm"], device_events=prof["device_events"],
               profiled_wall_ms=prof["profiled_wall_ms"],
               spins_seen_before_and_after=prof["spins_seen_before_and_after"],
               by_kernel=prof["by_kernel"], launches=launches, checks=checks,
               host_seconds=host, events=events)
    for k in ("its", "reason", "ksp_its", "ls_its", "ksp_type", "pc_type", "max_err", "ndof",
              "gamg_levels", "mg_levels", "history", "steps", "dt", "ncells", "nfaces"):
        if k in r and r[k] is not None:
            rec[k] = r[k]
    tabs = {}
    if case == "ex12_p2_256":
        tabs["add"] = ctx.ds._tables()["scatter"]
    if c["kind"] == "fvplex":
        t = ctx.fv._tables()
        tabs.update(signed=t["flux_scatter"], min=t["lim_scatter"])
    return rec, launches, tabs


def plex_x1_rows(tabs, flush, earlier):
    """X1 on phase plex's tables (PLEX_X1_TABLES), each mode against its
    plain version bit for bit and timed (x1_row)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(24)
    return {f"dst_scatter_{mode}_{case}": x1_row(mode, tabs[(case, mode)], flush, earlier, gen)
            for case, mode in PLEX_X1_TABLES}


def phase_plex(pt, smi, t_start, flush, earlier):
    """Every case of PLEX_CASES (plex_case), then X1's rows on their tables;
    returns (the phase's record, {case: launches}, the X1 rows)."""
    import torch
    contract = plex_contract()
    cases, by_case, tabs = [], {}, {}
    for case in PLEX_CASES:
        t0 = time.perf_counter()
        rec, launches, t = plex_case(pt, case, contract[case], flush)
        rec["seconds"] = time.perf_counter() - t0
        cases.append(rec)
        by_case[case] = launches
        tabs.update({(case, m): v for m, v in t.items()})
        torch.cuda.empty_cache()
    rows = plex_x1_rows(tabs, flush, earlier)
    del tabs
    torch.cuda.empty_cache()
    return {"phase": "plex", "nvidia_smi": smi, "cases": cases, "x1_rows": rows,
            "elapsed_s": time.perf_counter() - t_start}, by_case, rows


# ---------------------------------------------------------------------
# phase dm_more: the rest of DM (item 11b) and item 13 (I/O, PF, Random,
# ML); the inputs here are dm_contract.py's too
# ---------------------------------------------------------------------

DM_MORE_CASES = ("stokes_64", "stokes_512", "swarm_2d", "swarm_3d", "network_kcl", "letkf",
                 "regressor", "pf", "random", "io")
DM_STOKES_N = {"stokes_64": 64, "stokes_512": 512}
DM_SWARM = {"swarm_2d": (2, 1025, 4), "swarm_3d": (3, 129, 2)}   # dim, nodes per axis, ppcell
DM_SWARM_SEED = 25
DM_NETWORK_SIDE = 512          # 262,144 vertices, 523,264 edges
DM_LETKF = (16384, 32, 2048, 16.0)   # state points n, members k, observations m, GC radius
DM_LETKF_SEED = 26
# rows, columns, ridge weight, lasso weight, lasso's rows: the reference's
# lasso takes ||X||_2 by a full SVD (U is rows x rows: 137 GB at 131,072),
# so lasso fits the first 16,384 rows
DM_REGRESSOR = (131072, 64, 10.0, 819.2, 16384)
DM_REGRESSOR_SEED = 27
DM_PF = (1 << 24, "x*x + 1", 28)
DM_RANDOM = (1 << 24, (-1.0, 3.0), 1000)    # values, then an interval and a second draw
DM_IO_CONFIG2 = (22, 239, 239)
DM_IO_EX45 = 129
DM_HIST_RTOL = 1e-6


def swarm_grid(case):
    """(dim, nodes per axis, ppcell, particles, nodes) of a swarm case."""
    dim, nn, ppc = DM_SWARM[case]
    return dim, nn, ppc, ((nn - 1) * ppc) ** dim, nn ** dim


def swarm_inputs(case):
    """The case's seeded inputs: a permutation of the particles that
    insertPointsUsingCellDM placed, the particle fields w (in [0, 1)) and
    q (normal), and a nodal field (normal)."""
    import numpy as np
    _, _, _, npart, nnodes = swarm_grid(case)
    rng = np.random.default_rng(DM_SWARM_SEED + DM_SWARM[case][0])
    return (rng.permutation(npart), rng.random(npart), rng.standard_normal(npart),
            rng.standard_normal(nnodes))


def network_edges(side=None):
    """The side x side grid graph's edges (DM_NETWORK_SIDE by default),
    vertex r * side + c: every (v, v + 1) along rows, then every
    (v, v + side) along columns."""
    import numpy as np
    side = side or DM_NETWORK_SIDE
    v = np.arange(side * side, dtype=np.int64).reshape(side, side)
    return np.concatenate([np.stack([v[:, :-1].ravel(), v[:, 1:].ravel()], 1),
                           np.stack([v[:-1, :].ravel(), v[1:, :].ravel()], 1)])


def letkf_inputs():
    """(Xf (n, k), yo (m,), H (m, n) dense, R_diag (m,), localization (n, m)):
    a periodic line of n points observed every n / m points, Gaspari-Cohn
    weights of the periodic distance over the radius (gc: the package's
    gaspari_cohn)."""
    import numpy as np
    n, k, m, radius = DM_LETKF
    rng = np.random.default_rng(DM_LETKF_SEED)
    x = np.arange(n)
    truth = np.sin(2 * np.pi * x / n * 4) + 0.3 * np.cos(2 * np.pi * x / n * 17)
    Xf = truth[:, None] + 0.2 + 0.5 * rng.standard_normal((n, k))
    obs_at = np.arange(0, n, n // m)[:m]
    H = np.zeros((m, n))
    H[np.arange(m), obs_at] = 1.0
    R_diag = np.full(m, 0.25)
    yo = truth[obs_at] + 0.5 * rng.standard_normal(m)
    d = np.abs(x[:, None] - obs_at[None, :])
    dist = np.minimum(d, n - d) / radius
    return Xf, yo, H, R_diag, dist


def regressor_inputs():
    """(X, y): a seeded normal design, half of the true coefficients 0, an
    intercept of 3 and noise of 0.1."""
    import numpy as np
    rows, cols = DM_REGRESSOR[:2]
    rng = np.random.default_rng(DM_REGRESSOR_SEED)
    X = rng.standard_normal((rows, cols))
    coef = rng.standard_normal(cols) * (np.arange(cols) % 2)
    return X, X @ coef + 3.0 + 0.1 * rng.standard_normal(rows)


def pf_input():
    import numpy as np
    n, _, seed = DM_PF
    return np.random.default_rng(seed).standard_normal(n)


def sample_indices(n, k=16, seed=24):
    """k sorted distinct indices of 0..n-1, from a seeded generator."""
    import numpy as np
    return np.sort(np.random.default_rng(seed).choice(n, size=k, replace=False))


def vector_record(v):
    """A vector's 2-norm, sum, min, max and 16 seeded samples."""
    import numpy as np
    v = np.asarray(v, dtype=np.float64).ravel()
    idx = sample_indices(len(v))
    return {"n": len(v), "norm2": float(np.linalg.norm(v)), "sum": float(v.sum()),
            "min": float(v.min()), "max": float(v.max()),
            "sample_idx": idx.tolist(), "sample": [float(a) for a in v[idx]]}


def sha256(arr):
    import hashlib
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()



def dm_contract():
    return json.loads((DATA / "dm_contract.json").read_text())


def dm_stokes_launches(its):
    """One FGMRES(30) solve of the MAC Stokes system from zero: one S2 (A)
    and one K3 a step and one S2 at each later cycle's start; one PC
    application a step, fieldsplit Schur full: two K8 gathers (the fields),
    ILU(0) on the velocity block twice (2 T1 each), A10 and A01 (S2), two
    K2 subtractions, the Jacobi block on the host's library torch, and two
    X1 set scatters back."""
    cycles = max(1, math.ceil(its / 30))
    return {"gather": 2 * its, "trisolve": 4 * its, "csr_spmv": 3 * its + cycles - 1,
            "triad": 2 * its, "dst_scatter": 2 * its, "axpy_normsq": its}


def dm_more_launches_needed(kind, r):
    """The launches of one run of a phase dm_more case, from what it reports
    it did (r: the case's result)."""
    if kind == "stokes":
        return dm_stokes_launches(r["its"])
    if kind == "swarm":
        # depositSum one W1; projectFields (two fields and the weight sum)
        # one W1; interpolateToParticles one W2; the cell order (built once
        # for the three, applied by migrate) is library torch. A count is a
        # wrapper's launch: a W1 is three device launches (the staged
        # tiles, the dense tiles' list, the dense tiles) and a 2-D W2 two
        # (the corner-pair table, the interpolation)
        return {"cic_deposit": 2, "cic_interp": 1}
    if kind == "network":
        return {k: v for k, v in mg_launches_needed(r["its"], r["_nlev"]).items() if v}
    if kind == "io":
        return {"gather": 2}          # setValuesCOO: v[perm] and the diagonal
    return {}       # letkf, regressor (OLS by thin SVD), pf, random: library torch alone


def _spread_tol(c, key, want_k, k=None):
    """Twice the largest distance of the contract's perturbed runs
    (dm_contract.py --spread: b or A moved at rounding level) from the
    contract, for `key` (entry k of it; runs shorter than k + 1 entries
    left out); 0 without a spread."""
    sp = c.get("spread")
    runs = [] if not sp else sp[key] if k is None else [r[k] for r in sp[key] if len(r) > k]
    return 2 * max((abs(v - want_k) for v in runs), default=0.0)


def dm_stokes(pt, c, case):
    """examples/stokes_stag.py's steps at n: the vectorised MAC assembly
    (held to the contract's CSR hash), then from_scipy and the fieldsplit
    Schur FGMRES of stokes_stag.setup; run() solves from zero."""
    from petsc_tpu_torch.examples import stokes_stag
    n = DM_STOKES_N[case]
    secs = {}
    t = time.perf_counter()
    _, A_sp, b_np, offs = stokes_stag.assemble(n)
    secs["assemble"] = time.perf_counter() - t
    got = sha256(A_sp.indptr.astype("int64")) + sha256(A_sp.indices.astype("int64")) + \
        sha256(A_sp.data)
    if got != c["csr_sha256"]:
        raise AssertionError(f"{case}: the assembled CSR's hash differs from the reference's")
    pt.init(args=[])
    t = time.perf_counter()
    ksp, A, b = stokes_stag.setup(A_sp, b_np, offs[2])
    nl_sync()
    secs["from_scipy"] = time.perf_counter() - t

    def run():
        x = A.createVecRight()
        ksp.solve(b, x)
        return x

    def result(x):
        u_err, div = stokes_stag.errors(x.getArray(), n, offs[0], offs[1])
        return {"its": ksp.getIterationNumber(), "reason": int(ksp.getConvergedReason()),
                "history": [float(h) for h in ksp.getConvergenceHistory()], "u_err": u_err,
                "div": div, "x": x.array, "rows": A_sp.shape[0], "nnz": int(A_sp.nnz)}
    return run, result, SimpleNamespace(seconds=secs)


def dm_stokes_check(case, c, r):
    """Iterations within twice the reference's own spread (equal where its
    perturbed runs agree) and the reason equal; each history entry the two
    runs share to DM_HIST_RTOL (one at rounding level, below NL_HIST_FLOOR
    of the first, to NL_HIST_ABS of the first), or to twice the reference's
    own spread where that is larger; u_err, max|div u| and the solution's
    norm likewise (1e-8 relative, max|div u| 1e-9 absolute)."""
    its_tol = _spread_tol(c, "its", c["its"])
    if abs(r["its"] - c["its"]) > its_tol or r["reason"] != c["reason"]:
        raise AssertionError(f"{case}: its {r['its']}, reason {r['reason']}; the contract "
                             f"{c['its']} (within {its_tol}), {c['reason']}")
    got, want = r["history"], c["history"]
    if len(got) != r["its"] + 1:
        raise AssertionError(f"{case}: {len(got)} history entries for {r['its']} its")
    scale, worst, spread_held = abs(want[0]), 0.0, 0
    for k, (g, w) in enumerate(zip(got, want)):
        base = NL_HIST_ABS * scale if abs(w) < NL_HIST_FLOOR * scale else DM_HIST_RTOL * abs(w)
        tol = max(base, _spread_tol(c, "history", w, k))
        if not abs(g - w) <= tol:
            raise AssertionError(f"{case}: history entry {k} is {g!r}, want {w!r} within "
                                 f"{tol!r}")
        spread_held += abs(g - w) > base
        worst = max(worst, abs(g - w) / abs(w))
    out = {"its_held_within": its_tol, "history_worst_rel": worst,
           "history_entries_held_by_the_spread": spread_held}
    x_norm = float(r["x"].double().norm())
    for key, got_v, want_v, base in (("u_err", r["u_err"], c["u_err"], 1e-8 * c["u_err"]),
                                     ("div", r["div"], c["div"], 1e-9),
                                     ("x_norm2", x_norm, c["x"]["norm2"],
                                      1e-8 * c["x"]["norm2"])):
        tol = max(base, _spread_tol(c, key, want_v))
        if not abs(got_v - want_v) <= tol:
            raise AssertionError(f"{case}: {key} {got_v!r}, the contract's {want_v!r} "
                                 f"(limit {tol!r})")
        out[key] = {"got": got_v, "want": want_v, "held_within": tol}
    return out


def dm_swarm(pt, c, case):
    """A DMSwarm on the case's DMDA: insertPointsUsingCellDM, the seeded
    permutation, fields w and q, a nodal field (swarm_inputs); run()
    restores that state (the permuted coordinates and fields, on the
    device), then depositSum(w), projectFields([w, q]),
    interpolateToParticlesTensor and migrate."""
    import torch
    dim, nn, ppc, _, nnodes = swarm_grid(case)
    secs = {}
    t = time.perf_counter()
    perm, w, q, nodal = swarm_inputs(case)
    secs["inputs_host"] = time.perf_counter() - t
    pt.init(args=[])
    t = time.perf_counter()
    da = pt.DMDA.create(dim, (nn,) * dim)
    sw = pt.DMSwarm.create()
    sw.setCellDM(da)
    sw.insertPointsUsingCellDM(ppcell=ppc)
    dev = pt.config.device()
    X0 = sw.getFieldTensor("DMSwarmPIC_coor")[torch.as_tensor(perm, device=dev)]
    sw.setPointCoordinates(X0)
    sw.registerField("w", 1)
    sw.registerField("q", 1)
    w0 = torch.as_tensor(w, device=dev).reshape(-1, 1)
    q0 = torch.as_tensor(q, device=dev).reshape(-1, 1)
    nodal_v = pt.Vec.from_array(nodal)
    nl_sync()
    secs["setup"] = time.perf_counter() - t

    def run():
        sw.setPointCoordinates(X0)
        sw.restoreField("w", w0)
        sw.restoreField("q", q0)
        dep = sw.depositSum("w")
        proj = sw.projectFields(["w", "q"])
        interp = sw.interpolateToParticlesTensor(nodal_v)
        sw.migrate()
        return dep, proj, interp

    def result(out):
        dep, proj, interp = out
        return {"deposit": dep.array, "project_w": proj[0].array, "project_q": proj[1].array,
                "interpolate": interp, "cells": sw.binToCells(),
                "migrated_w": sw.getFieldTensor("w")}
    ctx = SimpleNamespace(seconds=secs, X=X0, w=w0[:, 0], q=q0[:, 0], nodal=nodal_v.array,
                          grid=sw._grid(), weight_sum=float(w.sum()))
    return run, result, ctx


def dm_swarm_check(case, c, r, ctx):
    """Each deposit's and the interpolation's norm, sum and samples to the
    contract (1e-12 relative; the interpolation 1e-13), the deposit's sum
    to the particle weights' (1e-12), the migrated order and cell ids
    equal in bits (their SHA-256)."""
    out = {}
    for key, tol in (("deposit", 1e-12), ("project_w", 1e-12), ("project_q", 1e-12),
                     ("interpolate", 1e-13)):
        v = r[key]
        out[key] = plex_vec_check(f"{case} {key}", v, c[key], tol)
        s = float(v.double().sum())
        rel = abs(s - c[key]["sum"]) / max(abs(c[key]["sum"]), 1e-300)
        if key != "project_q" and not rel <= tol:
            raise AssertionError(f"{case} {key}: sum {s!r}, the contract's {c[key]['sum']!r}")
        out[key]["sum_rel"] = rel
    tot = float(r["deposit"].double().sum())
    if not abs(tot - ctx.weight_sum) <= 1e-12 * ctx.weight_sum:
        raise AssertionError(f"{case}: deposit sums to {tot!r}, the weights to {ctx.weight_sum!r}")
    for key, want in (("migrated_w", "migrated_w_sha256"), ("cells", "migrated_cells_sha256")):
        if sha256(r[key].cpu().numpy()) != c[want]:
            raise AssertionError(f"{case}: {key} after migrate differ from the contract's")
    out["deposit_sum_rel_to_weights"] = abs(tot - ctx.weight_sum) / ctx.weight_sum
    return out


def dm_network(pt, c, case):
    """DMNetwork on the grid graph (network_edges), one 1-dof component a
    vertex; createMatrix's pattern; the Laplacian from incidence(),
    zeroRowsColumns at the first and last vertex (1 V at the first); CG +
    GAMG to rtol 1e-8; run() solves from zero."""
    import numpy as np
    import scipy.sparse as sp
    secs = {}
    edges = network_edges()
    nv = DM_NETWORK_SIDE ** 2
    pt.init(args=["-ksp_type", "cg", "-pc_type", "gamg", "-ksp_rtol", "1e-8"])
    t = time.perf_counter()
    net = pt.DMNetwork.create()
    net.addSubnetwork("grid", edges)
    net.layoutSetUp()
    key = net.registerComponent("bus")
    for v in range(nv):
        net.addComponent(v, key, 1)
    net.setUp()
    secs["layout"] = time.perf_counter() - t
    t = time.perf_counter()
    S = net.createMatrix().to_scipy()
    secs["createMatrix"] = time.perf_counter() - t
    got = sha256(S.indptr.astype("int64")) + sha256(S.indices.astype("int64"))
    if (int(S.nnz), got) != (c["nnz"], c["pattern_sha256"]):
        raise AssertionError(f"{case}: createMatrix's pattern ({S.nnz} entries) differs from "
                             f"the contract's ({c['nnz']})")
    src, dst = net.incidence()
    G = np.ones(len(src))
    L = sp.csr_matrix((np.concatenate([G, G, -G, -G]),
                       (np.concatenate([src, dst, src, dst]),
                        np.concatenate([src, dst, dst, src]))), shape=(nv, nv))
    t = time.perf_counter()
    A = pt.MatAIJ.from_scipy(L)
    xv = np.zeros(nv)
    xv[0] = 1.0
    b = pt.Vec.from_array(np.zeros(nv))
    A.zeroRowsColumns([0, nv - 1], diag=1.0, x=pt.Vec.from_array(xv), b=b)
    secs["laplacian"] = time.perf_counter() - t
    plex_vec_check(f"{case} b", b.array, c["b"], 1e-15)
    ksp = pt.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()

    def run():
        x = A.createVecRight()
        ksp.solve(b, x)
        return x

    def result(x):
        return {"its": ksp.getIterationNumber(), "reason": int(ksp.getConvergedReason()),
                "history": [float(h) for h in ksp.getConvergenceHistory()],
                "_nlev": len(ksp.getPC()._impl.levels), "x": x.array}
    return run, result, SimpleNamespace(seconds=secs, nnz=int(S.nnz), edges=len(edges))


def dm_letkf(pt, c, case):
    """letkf_analysis on letkf_inputs with Gaspari-Cohn localization, the
    inputs on the card; run() is one analysis."""
    import torch
    from petsc_tpu_torch.ml import gaspari_cohn, letkf_analysis
    secs = {}
    t = time.perf_counter()
    Xf, yo, H, R, dist = letkf_inputs()
    rho = gaspari_cohn(dist)
    secs["inputs_host"] = time.perf_counter() - t
    plex_vec_check(f"{case} rho", torch.as_tensor(rho).reshape(-1), c["rho"], 1e-15)
    pt.init(args=[])
    Xf, yo, H, R, rho = (torch.as_tensor(a, device=pt.config.device())
                         for a in (Xf, yo, H, R, rho))

    def run():
        return letkf_analysis(Xf, yo, H, R, localization=rho)

    def result(Xa):
        return {"Xa": Xa, "Xa_mean": Xa.mean(dim=1)}
    return run, result, SimpleNamespace(seconds=secs)


def dm_regressor(pt, c, case):
    """Regressor OLS (thin-SVD least squares), ridge and lasso (on the first lasso rows)
    on regressor_inputs, the design on the card; run() fits all three."""
    import torch
    X, y = regressor_inputs()
    _, _, ridge_w, lasso_w, lasso_rows = DM_REGRESSOR
    pt.init(args=[])
    X, y = (torch.as_tensor(a, device=pt.config.device()) for a in (X, y))
    fits = {}

    def run():
        for lt, wgt, m in (("ols", None, len(y)), ("ridge", ridge_w, len(y)),
                           ("lasso", lasso_w, lasso_rows)):
            r = pt.Regressor().create().setLinearType(lt)
            if wgt is not None:
                r.setRegularizerWeight(wgt)
            fits[lt] = r.fit(X[:m], y[:m])
        return fits

    def result(f):
        return {lt: {"coef": f[lt]._coef.cpu().numpy(), "intercept": f[lt].getIntercept()}
                for lt in f}
    return run, result, SimpleNamespace(seconds={})


def dm_regressor_check(case, c, r):
    import numpy as np
    out = {}
    for lt in ("ols", "ridge", "lasso"):
        want = np.asarray(c[lt]["coef"])
        err = float(np.abs(r[lt]["coef"] - want).max() / np.abs(want).max())
        ierr = abs(r[lt]["intercept"] - c[lt]["intercept"]) / abs(c[lt]["intercept"])
        if not (err <= 1e-10 and ierr <= 1e-10):
            raise AssertionError(f"{case} {lt}: coefficients {err:.3g}, intercept {ierr:.3g} "
                                 "relative from the contract's (limit 1e-10)")
        out[lt] = {"coef_rel": err, "intercept_rel": ierr,
                   "zeros": int((r[lt]["coef"] == 0).sum())}
    return out


def dm_pf(pt, c, case):
    """PF "x*x + 1" (string) on pf_input's 2^24 entries, from a Vec on the
    card into a Vec."""
    from petsc_tpu_torch.sys.pf import PF
    x = pf_input()
    pt.init(args=[])
    v = pt.Vec.from_array(x)
    y = v.duplicate()
    pf = PF.create().setType("string", DM_PF[1])

    def run():
        return pf.apply(v, y)

    def result(yv):
        return {"y": yv.array, "x": x}
    return run, result, SimpleNamespace(seconds={})


def dm_pf_check(case, c, r):
    """Equal in bits to numpy's x*x + 1 (each operation rounded alone); the
    reference's jitted map contracts to a fused multiply-add, so its
    entries may be one rounding away: norm2 and sum to 1e-15, samples to
    2.3e-16 relative (ROADMAP section 3)."""
    import numpy as np
    y = r["y"].cpu().numpy()
    x = r["x"]
    if not np.array_equal(y.view(np.int64), (x * x + 1).view(np.int64)):
        raise AssertionError(f"{case}: differs from numpy's x*x + 1")
    rec = vector_record(y)
    for key, tol in (("norm2", 1e-15), ("sum", 1e-15)):
        if not abs(rec[key] - c["y"][key]) <= tol * abs(c["y"][key]):
            raise AssertionError(f"{case}: {key} {rec[key]!r}, the contract's {c['y'][key]!r}")
    s, ws = np.asarray(rec["sample"]), np.asarray(c["y"]["sample"])
    if not np.all(np.abs(s - ws) <= 2.3e-16 * np.abs(ws)):
        raise AssertionError(f"{case}: samples {s} against {ws}")
    return {"equal_bits_with_the_contract": sha256(y) == c["sha256"],
            "samples_equal": int((s == ws).sum()), "norm2_rel": abs(rec["norm2"] - c["y"]["norm2"])
            / c["y"]["norm2"]}


def dm_random(pt, c, case):
    """Random().getValues(2^24) on the card, then setInterval and a second
    draw; the contract's SHA-256 of each, bit for bit."""
    n, interval, n2 = DM_RANDOM
    pt.init(args=[])

    def run():
        r = pt.Random()
        v = r.getValues(n)
        r.setInterval(interval)
        return v, r.getValues(n2)

    def result(out):
        return {"v": out[0], "v2": out[1]}
    return run, result, SimpleNamespace(seconds={})


def dm_io(pt, c, case):
    """Config 2's matrix assembled from COO on the card and written in PETSc
    binary; ex45's 129^3 right-hand side (compute_rhs into a card Vec)
    written as .vti; the files' SHA-256 against the contract's."""
    import hashlib
    import tempfile
    from petsc_tpu_torch.examples import ex45
    from petsc_tpu_torch.ops.stencil_build import stencil7_coo
    from petsc_tpu_torch.sys.viewer import mat_save
    from petsc_tpu_torch.sys.vtk import write_vtu
    i, j, v = stencil7_coo(*DM_IO_CONFIG2)
    n = DM_IO_EX45
    pt.init(args=[])
    secs = {}

    def run():
        t = time.perf_counter()
        A = pt.MatAIJ()
        A.setSizes(int(math.prod(DM_IO_CONFIG2)))
        A.setPreallocationCOO(i, j)
        A.setValuesCOO(v)
        da = pt.DMDA.create(3, (n, n, n), dof=1, stencil_width=1)
        b = da.createGlobalVector()
        ex45.compute_rhs(None, b)
        nl_sync()
        secs["build"] = time.perf_counter() - t
        out = {}
        with tempfile.TemporaryDirectory() as tmp:
            for f, write in (("config2.bin", lambda p: mat_save(p, A)),
                             ("ex45_rhs.vti", lambda p: write_vtu(da, p,
                                                                  point_data={"rhs": b}))):
                t = time.perf_counter()
                write(f"{tmp}/{f}")
                secs[f"write_{f}"] = time.perf_counter() - t
                data = Path(f"{tmp}/{f}").read_bytes()
                out[f] = {"bytes": len(data), "sha256": hashlib.sha256(data).hexdigest()}
        return out

    def result(out):
        return out
    return run, result, SimpleNamespace(seconds=secs)


DM_BUILD = {"stokes": dm_stokes, "swarm": dm_swarm, "network": dm_network, "letkf": dm_letkf,
            "regressor": dm_regressor, "pf": dm_pf, "random": dm_random, "io": dm_io}


def dm_kind(case):
    """stokes, swarm, network, letkf, regressor, pf, random or io."""
    return case.split("_")[0]


def dm_check(case, c, r, ctx):
    """The first run against the contract; returns the record's check entries."""
    kind = dm_kind(case)
    if kind == "stokes":
        return dm_stokes_check(case, c, r)
    if kind == "swarm":
        return dm_swarm_check(case, c, r, ctx)
    if kind == "network":
        if (r["its"], r["reason"]) != (c["its"], c["reason"]):
            raise AssertionError(f"{case}: its {r['its']}, reason {r['reason']}; the contract "
                                 f"{c['its']}, {c['reason']}")
        return {"history_worst_rel": nl_hist_check(case, r["history"], c["history"]),
                "x": plex_vec_check(f"{case} x", r["x"], c["x"], 1e-8)}
    if kind == "letkf":
        return {k: plex_vec_check(f"{case} {k}", r[k].reshape(-1), c[k], 1e-10)
                for k in ("Xa", "Xa_mean")}
    if kind == "regressor":
        return dm_regressor_check(case, c, r)
    if kind == "pf":
        return dm_pf_check(case, c, r)
    if kind == "random":
        got = (sha256(r["v"].cpu().numpy()), sha256(r["v2"].cpu().numpy()))
        if got != (c["sha256"], c["interval_sha256"]):
            raise AssertionError(f"{case}: the values differ from JAX's draw (SHA-256)")
        return {"equal_bits": True}
    if kind == "io":
        for f in ("config2.bin", "ex45_rhs.vti"):
            if r[f] != c[f]:
                raise AssertionError(f"{case}: {f} {r[f]} differs from the contract's {c[f]}")
        return {"equal_bytes": True, **r}
    raise KeyError(kind)


def dm_case(pt, case, c):
    """One case: its first run with every launch count set to 0 just before
    and read just after (nl_first, held exactly to dm_more_launches_needed),
    checked against the contract; the best of NL_WARM_REPS warm runs (one
    where a run takes over NL_ONE_WARM_MS); one profiled run. Returns
    (record, launches, context)."""
    kind = dm_kind(case)
    t0 = time.perf_counter()
    run, result, ctx = DM_BUILD[kind](pt, c, case)
    build_s = time.perf_counter() - t0
    r, launches, events, first_s = nl_first(pt, case, {"kind": kind}, run, result,
                                            needed=dm_more_launches_needed)
    checks = dm_check(case, c, r, ctx)
    warm = math.inf
    for _ in range(NL_WARM_REPS):
        nl_sync()
        t1 = time.perf_counter()
        run()
        nl_sync()
        warm = min(warm, (time.perf_counter() - t1) * 1e3)
        if warm > NL_ONE_WARM_MS:
            break
    prof = nl_profile(run, warm)
    host = dict(ctx.seconds)
    host["pcsetup"] = sum(v for k, v in events.items() if k.startswith("PCSetUp"))
    rec = {"case": case, "kind": kind, "build_s": build_s, "first_s": first_s, "warm_ms": warm,
           "busy_ms": prof["device_busy_ms"], "busy_share": prof["busy_share_of_warm"],
           "device_events": prof["device_events"], "profiled_wall_ms": prof["profiled_wall_ms"],
           "spins_seen_before_and_after": prof["spins_seen_before_and_after"],
           "by_kernel": prof["by_kernel"], "launches": launches, "checks": checks,
           "host_seconds": host, "events": events}
    if kind == "stokes":
        t1 = sum(k["ms"] for k in prof["by_kernel"] if "trisolve" in k["name"])
        rec.update(its=r["its"], reason=r["reason"], rows=r["rows"], nnz=r["nnz"],
                   u_err=r["u_err"], div=r["div"], t1_busy_ms=t1,
                   t1_share_of_busy=t1 / prof["device_busy_ms"] if prof["device_busy_ms"] else None)
    if kind == "network":
        rec.update(its=r["its"], reason=r["reason"], gamg_levels=r["_nlev"], nnz=ctx.nnz,
                   edges=ctx.edges)
    return rec, launches, ctx


def same_bits(a, b):
    """a and b equal bit for bit (so -0 and +0 differ, and a NaN equals
    itself), on the host."""
    import torch
    a, b = a.cpu().contiguous(), b.cpu().contiguous()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = torch.int64 if a.dtype == torch.float64 else torch.int32
    return torch.equal(a.view(view), b.view(view))


def w1_check(X, grid, fields, wsum=False, order=None, capacity=-1):
    """W1 equal in bits to its plain version run on the host's CPU (serial
    index_add_ a corner after another: the reference's order; CUDA's
    index_add_ adds with atomics and has no fixed bits), in f64 and f32;
    `capacity` is cic_deposit's _capacity (0: every tile with a particle
    left to the dense kernel).
    Returns (W1's table, max |W1 - plain|: 0.0 when it passes)."""
    from petsc_tpu_torch.ops import particle_kernels as ppk
    got = ppk.cic_deposit(X, grid, fields, wsum, order=order, _capacity=capacity)
    plain = ppk.cic_deposit_plain(X.cpu(), grid, [f.cpu() for f in fields], wsum)
    if not same_bits(got, plain):
        raise AssertionError(f"W1: {int((got.cpu() != plain).sum())} entries differ from the "
                             "plain version on the host's CPU")
    return got, 0.0


def w2_variants(dim):
    """W2's launch shapes timed against each other (particles a thread,
    flags; earlier_kernels/swarm_cic_interp_shapes.cu): the one-wave
    grid-stride loop; 1, 2 and 4 a thread, each plain, with the aligned
    corner pairs in one load (flag 2) and with the corner-pair table (flag
    4); in 2-D 1 and 2 a thread with 16-byte coordinate loads (flag 1) and
    each of the others."""
    out = [(0, 0)] + [(ppt, fl) for fl in (0, 2, 4) for ppt in (1, 2, 4)]
    return out + ([(ppt, fl) for fl in (1, 3, 5) for ppt in (1, 2)] if dim == 2 else [])


# the shape among w2_variants that the package's W2 launches, per dimension
W2_SHIPPED = {1: (1, 2), 2: (1, 4), 3: (1, 2)}


def w2_check(X, grid, v):
    """W2 equal to its plain version in bits. Returns (out, max |W2 -
    plain|)."""
    from petsc_tpu_torch.ops import particle_kernels as ppk
    got, plain = ppk.cic_interp(X, grid, v), ppk.cic_interp_plain(X, grid, v)
    if not same_bits(got, plain):
        raise AssertionError(f"W2: {int((got != plain).sum())} entries differ from the plain "
                             "version")
    return got, 0.0


def cic_edge_cases(device, dtype):
    """W1/W2 operands that reach the clamps and the chunking: particles on
    cell edges, at x = 1 and beyond the box (clipped to the last cell),
    below 0 (the first), every dim, six fields (two W1 launches), n = 1."""
    import numpy as np
    import torch
    from petsc_tpu_torch.ops import particle_kernels as ppk
    rng = np.random.default_rng(52)
    out = []
    for dim, sizes in ((1, (33,)), (2, (17, 9)), (3, (5, 7, 6))):
        grid = ppk.Grid(sizes)
        n = 3001
        X = rng.random((n, dim)) * 1.2 - 0.1
        X[:40] = np.round(X[:40] * grid.ncell) / grid.ncell      # on cell edges
        X[40:45] = 1.0
        X = torch.as_tensor(X, dtype=dtype, device=device)
        fields = [torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=device)
                  for _ in range(6)]
        v = torch.as_tensor(rng.standard_normal(grid.nnodes), dtype=dtype, device=device)
        out.append((f"{dim}d", X, grid, fields, v))
    grid = ppk.Grid((4, 4))
    X = torch.full((1, 2), 0.3, dtype=dtype, device=device)
    one = [torch.ones(1, dtype=dtype, device=device)]
    out.append(("one_particle", X, grid, one, torch.ones(16, dtype=dtype, device=device)))
    return out


def cic_edge_checks(device="cuda"):
    """W1 (one field; six fields with the weight sum, given its cell order
    and not; every tile with a particle left to the dense kernel, a
    particle a node a round, and the denser tiles, 66 a round; the
    particles put in cell order) and W2 on cic_edge_cases,
    f64 and f32, each equal in bits to its plain version on the host's CPU:
    the rows of phase kernels' checks."""
    import torch
    from petsc_tpu_torch.ops import particle_kernels as ppk
    rows = []
    for dtype in (torch.float64, torch.float32):
        for label, X, grid, fields, v in cic_edge_cases(device, dtype):
            _, e1 = w1_check(X, grid, fields[:1])
            _, e6 = w1_check(X, grid, fields, wsum=True)
            _, eo = w1_check(X, grid, fields, wsum=True, order=ppk.cell_order(X, grid))
            _, es = w1_check(X, grid, fields, wsum=True, capacity=0)
            w1_check(X, grid, fields, wsum=True, capacity=600)
            # the swarm put in cell order (as migrate leaves it): the identity order
            o = ppk.cell_order(X, grid)
            w1_check(o.Xs, grid, [f.index_select(0, o.perm) for f in fields], wsum=True,
                     order=ppk.identity_order(o, o.Xs))
            _, e2 = w2_check(X, grid, v)
            rows.append({"name": "cic", "case": label, "dtype": str(dtype)[6:],
                         "w1_max_abs_err": max(e1, e6, eo, es), "w1_equal_bits": True,
                         "w1_dense_equal_bits": True, "w2_equal_bits": e2 == 0.0})
    return rows


def cic_grid_sample(X, grid, v):
    """interpolateToParticles as one PyTorch call, W2's library yardstick:
    grid_sample's bilinear interpolation (trilinear on a 5-D input) with
    align_corners=True is cloud-in-cell on the unit box's nodes, its grid
    the coordinates mapped to [-1, 1] with the last axis first. Returns
    (the call, a check of it against cic_interp_plain: max |diff|, held
    to 1e-14 of max |v|)."""
    import torch.nn.functional as F
    from petsc_tpu_torch.ops import particle_kernels as ppk
    n, dim = X.shape
    g = (2 * X - 1).flip(-1).reshape(1, *([1] * (dim - 1)), n, dim)
    vv = v[: grid.nnodes].view(1, 1, *grid.sizes)

    def call():
        return F.grid_sample(vv, g, mode="bilinear", align_corners=True)

    err = float((call().reshape(n) - ppk.cic_interp_plain(X, grid, v)).abs().max())
    tol = 1e-14 * max(1.0, float(v.abs().max()))
    if not err <= tol:
        raise AssertionError(f"grid_sample: {err!r} from W2's plain version (limit {tol!r})")
    return call, err


def earlier_cic_deposit(earlier, X, grid, fields, wsum):
    """W1's earlier atomic design (earlier_kernels/swarm_cic_atomic.cu): one
    launch of up to four fields and the weight sum into a zeroed table, on
    the current stream."""
    import torch
    from petsc_tpu_torch.ops import cuda_build
    acc = torch.zeros((len(fields) + int(wsum), grid.nnodes), dtype=X.dtype, device=X.device)
    fn = getattr(earlier, "ptt_earlier_cic_deposit_" + ("f64" if X.dtype == torch.float64
                                                        else "f32"))
    ptrs = [f.data_ptr() for f in fields] + [None] * (4 - len(fields))
    cuda_build.check("earlier cic_deposit", fn(
        X.data_ptr(), X.shape[0], grid.dim, *ptrs, len(fields), int(wsum), acc.data_ptr(),
        grid.nnodes, *grid.args(), X.get_device(), torch.cuda.current_stream().cuda_stream))
    return acc


def earlier_cic_pairs(earlier, v, pairs):
    """The corner-pair table (v[i], v[i + 1]) into `pairs`, as W2's 2-D
    launch fills it first (earlier_kernels/swarm_cic_interp_shapes.cu)."""
    import torch
    from petsc_tpu_torch.ops import cuda_build
    fn = getattr(earlier, "ptt_earlier_cic_pairs_" + ("f64" if v.dtype == torch.float64
                                                      else "f32"))
    cuda_build.check("earlier cic_pairs", fn(
        v.data_ptr(), pairs.data_ptr(), pairs.shape[0], v.get_device(),
        torch.cuda.current_stream().cuda_stream))


def earlier_cic_interp(earlier, X, grid, v, variant, nodiv=False):
    """W2 in launch shape `variant` (w2_variants) from
    earlier_kernels/swarm_cic_interp_shapes.cu, the pair table filled first
    where the shape reads it; with `nodiv` its divisions by h are products
    with 1 / h (timing only: other bits)."""
    import torch
    from petsc_tpu_torch.ops import cuda_build
    out = torch.empty(X.shape[0], dtype=X.dtype, device=X.device)
    pairs = torch.empty((grid.nnodes, 2), dtype=X.dtype, device=X.device)
    if variant[1] & 4:
        earlier_cic_pairs(earlier, v, pairs)
    fn = getattr(earlier, "ptt_earlier_cic_interp_" + ("f64" if X.dtype == torch.float64
                                                       else "f32"))
    cuda_build.check("earlier cic_interp", fn(
        X.data_ptr(), X.shape[0], grid.dim, v.data_ptr(), pairs.data_ptr(), out.data_ptr(),
        *grid.args(), *variant, int(nodiv), X.get_device(),
        torch.cuda.current_stream().cuda_stream))
    return out


# W1's clustered swarm: every particle drawn from one Gaussian (centre,
# standard deviation per axis, seed), as a beam or a sheath gathers them
CIC_CLUSTER = (0.5, 0.05, 61)


def clustered_coordinates(n, dim, device):
    """n particles of a seeded Gaussian cluster (CIC_CLUSTER) in the unit
    box, in random order; the few beyond the box fall in its boundary
    cells, as the reference's clip puts them."""
    import numpy as np
    import torch
    centre, sd, seed = CIC_CLUSTER
    X = np.random.default_rng(seed).normal(centre, sd, size=(n, dim))
    return torch.as_tensor(X, device=device)


def cic_rows(ctxs, flush, earlier):
    """W1 (depositSum's one field; projectFields' two fields and the weight
    sum) and W2 at each swarm case's shapes. W1: equal in bits to its plain
    version on the host's CPU, f64 and f32, given its cell order, bare and
    with every tile left to the dense kernel; timed with its order given in turns with the
    earlier atomic design (earlier, new, new, earlier), cell_order alone,
    the bare call (the order built inside), index_add_ of the precomputed
    corner entries and the plain version, beside the bound with its bytes
    (the coordinates, the fields and the table moved once; the order's
    permutation and offsets reported beside it as the order's overhead);
    then the same particle count in a Gaussian cluster
    (clustered_coordinates: in bits against the host, f64, and timed
    against the atomic design and index_add_); each swarm also put in cell
    order (the identity order, as migrate leaves it). W2: its time beside each
    launch shape of w2_variants (each equal in bits to the plain version),
    the shapes without the division (timing only), the pair table's fill
    alone (2-D) and grid_sample (cic_grid_sample)."""
    import numpy as np
    import torch
    from petsc_tpu_torch.ops import particle_kernels as ppk
    rows = {}
    for case, ctx in ctxs.items():
        X, grid, nodal = ctx.X, ctx.grid, ctx.nodal
        n, dim, nn = X.shape[0], grid.dim, grid.nnodes
        ncells = int(np.prod(grid.ncell))
        for swarm in ("uniform", "clustered"):
            if swarm == "clustered":
                X = clustered_coordinates(n, dim, ctx.X.device)
            order = ppk.cell_order(X, grid)
            most = int((order.offsets[1:] - order.offsets[:-1]).max())
            corners = ppk.corners(X, grid)
            nid = torch.cat([c[0] for c in corners])
            for label, fields, wsum in (("deposit", [ctx.w], False),
                                        ("project", [ctx.w, ctx.q], True)):
                got, err = w1_check(X, grid, fields, wsum, order=order)
                if swarm == "uniform":
                    X32 = X.float()
                    w1_check(X32, grid, [f.float() for f in fields], wsum,
                             order=ppk.cell_order(X32, grid))
                    del X32
                dense = ppk.cic_deposit(X, grid, fields, wsum, order=order, _capacity=0)
                if not (same_bits(dense, got)
                        and same_bits(ppk.cic_deposit(X, grid, fields, wsum), got)):
                    raise AssertionError(f"W1 {case} {swarm} {label}: the bare call or every "
                                         "tile dense differs in bits")
                del dense
                nout = len(fields) + int(wsum)

                def new():
                    return ppk.cic_deposit(X, grid, fields, wsum, order=order)

                def old():
                    return earlier_cic_deposit(earlier, X, grid, fields, wsum)
                turns = [time_ms(old, flush), time_ms(new, flush), time_ms(new, flush),
                         time_ms(old, flush)]
                ms, earlier_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
                order_ms = time_ms(lambda: ppk.cell_order(X, grid), flush)
                bare_ms = time_ms(lambda: ppk.cic_deposit(X, grid, fields, wsum), flush)
                vals = torch.cat([torch.cat([w * f for _, w in corners]) for f in fields]
                                 + ([torch.cat([w for _, w in corners])] if wsum else []))
                idx = torch.cat([nid + k * nn for k in range(nout)])
                acc = torch.zeros(nout * nn, dtype=X.dtype, device=X.device)
                lib_ms = time_ms(lambda: acc.zero_().index_add_(0, idx, vals), flush)
                del vals, idx, acc
                flops = n * (3 * dim + (1 << dim) * (2 * dim + nout))
                # the function's bytes: the coordinates, the fields and the
                # table once; the order's permutation and offsets beside them
                nbytes = 8 * (n * dim + n * len(fields) + nout * nn)
                order_bytes = 4 * n + 4 * (ncells + 1)
                b_ms, b_by = bound(nbytes, flops, "float64")
                row = {
                    "name": "cic_deposit", "case": case, "swarm": swarm, "mode": label,
                    "dtype": "float64", "particles": n, "nodes": nn,
                    "most_particles_in_a_cell": most, "fields": len(fields), "wsum": wsum,
                    "max_abs_err": err,
                    "equal_bits_host_plain": ["float64", "float32"] if swarm == "uniform"
                    else ["float64"],
                    "equal_bits_bare_and_all_dense": True, "ms": ms, "turns_ms": turns,
                    "earlier": "the atomic design, a thread a particle "
                               "(earlier_kernels/swarm_cic_atomic.cu)",
                    "earlier_ms": earlier_ms, "cell_order_ms": order_ms, "bare_ms": bare_ms,
                    "library_ms": lib_ms,
                    "library": "index_add_ of the precomputed corner entries",
                    "bytes": nbytes, "order_overhead_bytes": order_bytes, "bound_ms": b_ms,
                    "bound_by": b_by, "share_of_bound": b_ms / ms,
                    "aim_faster_than_library": ms < lib_ms,
                    "aim_quarter_of_bound": b_ms / ms >= 0.25,
                    "aim_bare_faster_than_library": bare_ms < lib_ms}
                # the swarm in cell order (as migrate leaves it): the identity
                # order, the fields read in order; the same bits
                sfields = [f.index_select(0, order.perm) for f in fields]
                ident = ppk.identity_order(order, order.Xs)
                if not same_bits(ppk.cic_deposit(order.Xs, grid, sfields, wsum, order=ident),
                                 got):
                    raise AssertionError(f"W1 {case} {swarm} {label}: the swarm in cell "
                                         "order differs in bits")
                row["in_cell_order_ms"] = time_ms(
                    lambda: ppk.cic_deposit(order.Xs, grid, sfields, wsum, order=ident), flush)
                row["in_cell_order_share_of_bound"] = b_ms / row["in_cell_order_ms"]
                del sfields, ident
                if swarm == "uniform":
                    row["plain_ms"] = time_ms(
                        lambda: ppk.cic_deposit_plain(X, grid, fields, wsum), flush, reps=3)
                    rows[f"cic_deposit_{label}_{case}"] = row
                else:
                    rows[f"cic_deposit_{label}_{case}_clustered"] = row
                del got
            del corners, nid, order
            torch.cuda.empty_cache()
        X = ctx.X
        order = ppk.cell_order(X, grid)
        _, err = w2_check(X, grid, nodal)
        ms = time_ms(lambda: ppk.cic_interp(X, grid, nodal), flush)
        variants = {}
        for variant in w2_variants(dim):
            out = earlier_cic_interp(earlier, X, grid, nodal, variant)
            if not same_bits(out, ppk.cic_interp_plain(X, grid, nodal)):
                raise AssertionError(f"W2 {case}: launch shape {variant} differs in bits")
            variants[f"ppt{variant[0]}_flags{variant[1]}"] = time_ms(
                lambda variant=variant: earlier_cic_interp(earlier, X, grid, nodal, variant),
                flush)
        del out
        nodiv = {f"ppt1_flags{fl}": time_ms(
            lambda fl=fl: earlier_cic_interp(earlier, X, grid, nodal, (1, fl), nodiv=True),
            flush) for fl in sorted({0, 2, W2_SHIPPED[dim][1]})}
        pair_fill_ms = None
        if dim == 2:
            pairs = torch.empty((nn, 2), dtype=X.dtype, device=X.device)
            pair_fill_ms = time_ms(lambda: earlier_cic_pairs(earlier, nodal, pairs), flush)
            del pairs
        plain_ms = time_ms(lambda: ppk.cic_interp_plain(X, grid, nodal), flush, reps=3)
        lib, lib_err = cic_grid_sample(X, grid, nodal)
        lib_ms = time_ms(lib, flush)
        # the swarm in cell order: W2 and grid_sample on the sorted coordinates
        w2_check(order.Xs, grid, nodal)
        sorted_ms = time_ms(lambda: ppk.cic_interp(order.Xs, grid, nodal), flush)
        lib_sorted = cic_grid_sample(order.Xs, grid, nodal)[0]
        lib_sorted_ms = time_ms(lib_sorted, flush)
        del lib, lib_sorted
        nbytes = 8 * (n * dim + nn + n)
        b_ms, b_by = bound(nbytes, n * (3 * dim + (1 << dim) * (2 * dim + 2)), "float64")
        rows[f"cic_interp_{case}"] = {
            "name": "cic_interp", "case": case, "dtype": "float64", "particles": n, "nodes": nn,
            "max_abs_err": err, "equal_bits": True, "ms": ms,
            "shape": "ppt{}_flags{}".format(*W2_SHIPPED[dim]),
            "device_launches": 2 if dim == 2 else 1, "pair_fill_ms": pair_fill_ms,
            "variants_ms": variants, "variants_equal_bits": True,
            "nodiv_timing_only_ms": nodiv, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library": "grid_sample (bilinear, align_corners) on the mapped coordinates",
            "library_max_abs_diff": lib_err, "bytes": nbytes, "bound_ms": b_ms,
            "bound_by": b_by, "share_of_bound": b_ms / ms,
            "aim_faster_than_library": ms < lib_ms,
            "in_cell_order_ms": sorted_ms, "in_cell_order_library_ms": lib_sorted_ms}
        del order
        torch.cuda.empty_cache()
    return rows


def phase_dm_more(pt, smi, t_start, flush, earlier):
    """Every case of DM_MORE_CASES (dm_case), then W1's and W2's rows on the
    swarm cases' shapes; returns (the phase's record, {case: launches}, the
    rows)."""
    import torch
    contract = dm_contract()
    cases, by_case, swarms = [], {}, {}
    for case in DM_MORE_CASES:
        t0 = time.perf_counter()
        rec, launches, ctx = dm_case(pt, case, contract[case])
        rec["seconds"] = time.perf_counter() - t0
        cases.append(rec)
        by_case[case] = launches
        if dm_kind(case) == "swarm":
            swarms[case] = ctx
        torch.cuda.empty_cache()
    rows = cic_rows(swarms, flush, earlier)
    del swarms
    torch.cuda.empty_cache()
    return {"phase": "dm_more", "nvidia_smi": smi, "cases": cases, "cic_rows": rows,
            "left_out": "HDF5 (Plex viewHDF5/createFromHDF5, ViewerHDF5): the card's machine "
                        "has no h5py; the CPU tests hold it",
            "elapsed_s": time.perf_counter() - t_start}, by_case, rows

# ---------------------------------------------------------------------
# phase dist: distribution over ranks (ROADMAP queue 1 item 12, the
# linear-algebra half): DIST_RANKS gloo ranks, one process each, sharing
# the one card; a one-rank NCCL group for the collectives on CUDA tensors
# ---------------------------------------------------------------------

DIST_RANKS = 4
DIST_GROUP_TIMEOUT_S = 300      # the gloo group's timeout: a stuck rank fails its phase
DIST_WALL_S = 900               # the parent's wait for every rank
# case: (grid n, operator, options); dist_contract.py runs the same on the JAX
# package and writes tests/data/dist_contract.json
DIST_CASES = {
    "main_f64": (128, "grid", ("-ksp_type", "cg", "-pc_type", "gamg", "-ksp_max_it", "100")),
    "main_f32": (128, "grid", ("-ksp_type", "cg", "-pc_type", "gamg", "-ksp_max_it", "100",
                               "-pc_mg_dtype", "single")),
    "jacobi_128": (128, "aij", ("-ksp_type", "cg", "-pc_type", "jacobi", "-ksp_max_it", "3000")),
    "gamg_dist_64": (64, "aij", ("-ksp_type", "cg", "-pc_type", "gamg", "-ksp_max_it", "100")),
    "bjacobi_64": (64, "aij", ("-ksp_type", "cg", "-pc_type", "bjacobi", "-ksp_max_it", "400")),
    "fieldsplit_16": (16, "fieldsplit", ("-ksp_type", "fgmres", "-pc_type", "fieldsplit",
                                         "-pc_fieldsplit_type", "schur",
                                         "-pc_fieldsplit_schur_precondition", "selfp",
                                         "-ksp_max_it", "200")),
}
DIST_HIST_TOL = {"f64": 1e-6, "f32": 1e-4}   # sums over the ranks in another order; f32's cycle
DIST_RELRES_FACTOR = 10.0
DIST_KERNELS = ("csr_spmv", "dnd_stencil", "q1_prolong", "q1_restrict", "cheby_update",
                "triad", "axpy_normsq", "dot2", "trisolve", "gather", "dst_scatter")


def dist_contract():
    return json.loads((DATA / "dist_contract.json").read_text())


def dist_operator(n, kind):
    """(host CSR, b) of a phase dist case (dist_contract.py's operator)."""
    import numpy as np
    import scipy.sparse as sp
    if kind == "fieldsplit":
        I = sp.eye(n)
        T = sp.diags([2.0 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)], [0, 1, -1])
        A = ((sp.kron(sp.kron(T, I), I) + sp.kron(sp.kron(I, T), I)
              + sp.kron(sp.kron(I, I), T)).tocsr() + sp.eye(n ** 3) * 0.5).tocsr()
        return A, A @ np.ones(n ** 3)
    i, j, v = box27_coo(n)
    return sp.csr_matrix((v, (i, j)), shape=(n ** 3, n ** 3)), np.ones(n ** 3)


def _add(total, part, times=1):
    for k, v in part.items():
        total[k] = total.get(k, 0) + times * v
    return total


def dist_bcast_launches(plan, device):
    """One ExchangePlan.bcast on this rank: K8 for the pack where the rank
    sends, X1 for the unpack where it receives (the all-gather lowering:
    K8 where it has leaves)."""
    tab = plan._tables(device)
    if plan.use_allgather:
        return {"gather": int(tab["n"] > 0)}
    return {"gather": int(len(tab["send_idx"]) > 0), "dst_scatter": int(tab["rcnt"].sum() > 0)}


def dist_op_launches(meta, data, transpose=False):
    """The launches of one product (or, with transpose, one transposed
    product) of an operator on this rank, from its meta and data."""
    kind = meta[0]
    if kind in ("aij_csr", "p_row_block"):
        return {"csr_spmv": 1}
    if kind in ("aij_dnd", "dnd_mpi"):
        return {product_kernel(meta) if kind == "aij_dnd" else "dnd_stencil": 1}
    if kind in ("interp_q1", "interp_q1_mpi"):
        return {"q1_restrict" if transpose else "q1_prolong": 1}
    if kind == "mpiaij":
        has_off = bool(meta[6])
        return _add({"csr_spmv": 1 + has_off, "triad": int(has_off)},
                    dist_bcast_launches(data["sf"], data["diag"].device))
    raise ValueError(f"dist_op_launches: {kind}")


def dist_pc_launches(meta, data):
    """One application of a PC on this rank: Jacobi none (a torch product),
    ILU's two T1 sweeps, the V-cycle (each level but the coarsest: 5
    products with A, 4 C1 and 2 K2, its P and its restriction; the
    coarsest a dense LU solve), fieldsplit-Schur's full factorisation
    (two takes, B0 twice, B1, A10, A01, two K2, two puts)."""
    kind = meta[0]
    if kind == "pc_jacobi":
        return {}
    if kind == "pc_trisolve":
        return {"trisolve": 2}
    if kind == "pc_mg":
        _, cycle, nlev, lev_metas, _ = meta
        if cycle != "v":
            raise ValueError(cycle)
        need = {}
        for lm, ld in zip(lev_metas[:-1], data["levels"][:-1]):
            A_meta, P_meta, R_meta, smoother, pre, post = lm
            if smoother != "chebyshev" or (pre, post) != (2, 2):
                raise ValueError(lm)
            _add(need, dist_op_launches(A_meta, ld["A"]), 5)
            _add(need, {"cheby_update": 4, "triad": 2})
            _add(need, dist_op_launches(P_meta, ld["P"]))
            _add(need, dist_op_launches(P_meta, ld["P"], transpose=True) if R_meta is None
                 else dist_op_launches(R_meta, ld["R"]))
        return need
    if kind == "pc_fieldsplit":
        _, ftype, sfact, _, sub_metas, bmetas = meta
        if (ftype, sfact) != ("schur", "full"):
            raise ValueError(meta[:3])
        need = {}
        b0, b1 = (dist_pc_launches(m, d) for m, d in zip(sub_metas, data["subs"]))
        _add(need, b0, 2)
        _add(need, b1)
        for k, bm in bmetas:
            _add(need, dist_op_launches(bm, data["blocks"][k]))
        _add(need, {"triad": 2})
        for mv in data["moves"]:
            dev = data["blocks"][(0, 1)]["diag"].device
            _add(need, dist_bcast_launches(mv.take_plan, dev))
            _add(need, dist_bcast_launches(mv.put_plan, dev))
            _add(need, {"dst_scatter": 1})
        return need
    raise ValueError(f"dist_pc_launches: {kind}")


def dist_head_setup_launches(levels, probes=27, lanczos=10):
    """The sharded structured head's set-up on this rank: per head level
    (a slab Q1 P), 10 Lanczos products with its A and 27 probes of one
    Q1P, one product and one Q1R."""
    need = {}
    for lev in levels[:-1]:
        if lev.P.meta[0] == "interp_q1_mpi":
            _add(need, {"dnd_stencil": probes + lanczos, "q1_prolong": probes,
                        "q1_restrict": probes})
    return need


def dist_launches_needed(ksp):
    """Every launch of one distributed solve on this rank, set-up included,
    from what the solve reports (its, the bound operator and PC): CG's
    its products, 2 K2, one K3 and 2 K4 an iteration, one K4 and its + 1
    PC applications; FGMRES's its products and PC applications, one K3 an
    iteration (a zero guess: the first cycle has no residual product)."""
    its = ksp.getIterationNumber()
    A = ksp.getOperators()[0]
    pc = ksp.getPC()
    a = dist_op_launches(A.meta, A.device_data())
    p = dist_pc_launches(pc.meta, pc.device_data())
    need = {}
    if ksp.getType() == "cg":
        _add(need, a, its)
        _add(need, p, its + 1)
        _add(need, {"triad": 2 * its, "axpy_normsq": its, "dot2": 1 + 2 * its})
    elif ksp.getType() == "fgmres":
        restart = 30
        _add(need, a, its + (its - 1) // restart)
        _add(need, p, its)
        _add(need, {"axpy_normsq": its})
    else:
        raise ValueError(ksp.getType())
    levels = getattr(pc._impl, "levels", None)
    if levels:
        _add(need, dist_head_setup_launches(levels))
    return {k: v for k, v in need.items() if v}


def dist_levels(ksp):
    """[(A kind, rows)] of a multigrid PC's levels, the replicated tail's
    kinds as the reference names its layouts' family (aij)."""
    levels = getattr(ksp.getPC()._impl, "levels", None) or []
    return [(lev.A.meta[0], lev.A.getSize()[0]) for lev in levels]


def _profile_busy_ms(fn):
    """Device kernel milliseconds of fn() by torch.profiler (None where the
    profiler sees no device time), and fn's wall milliseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    us = 0.0
    for e in prof.key_averages():
        us += float(getattr(e, "self_device_time_total", 0.0)
                    or getattr(e, "self_cuda_time_total", 0.0) or 0.0)
    return (us / 1e3 if us > 0 else None), wall


def dist_case(pt, name, n, kind, opts, device=None, cache=None, timing=True):
    """One phase dist case on this rank: assemble the operator on the
    ranks, set up, solve (the launches counted from the assembly on), and,
    with timing, time a warm solve and profile another. Returns the
    record and the (ksp, A, b, x, host CSR, b host)."""
    import numpy as np
    import torch
    from petsc_tpu_torch.parallel.mesh import make_comm
    pt.init(args=["-ksp_rtol", "1e-8", *opts], device=device)
    comm = make_comm(DIST_RANKS)
    cache = {} if cache is None else cache
    key = (n, kind == "fieldsplit")
    if key not in cache:
        cache.clear()          # one host operator at a time (0.9 GB at 128^3)
        cache[key] = dist_operator(n, kind)
    A_sp, b_np = cache[key]
    cuda = torch.cuda.is_available() and device != "cpu"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    reset_launches()
    t0 = time.perf_counter()
    if (n, kind) not in cache:
        # the f64 and f32 cycles' cases share the distributed operator (its
        # assembly launches no kernel)
        A = pt.MatAIJ.from_scipy(A_sp, comm=comm)
        if kind == "grid":
            A.setStencilGrid((n,) * 3)
        cache[n, kind] = A
    A = cache[n, kind]
    ksp = pt.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    if kind == "fieldsplit":
        N = A_sp.shape[0]
        ksp.getPC().setFieldSplitIS(("0", np.arange(0, N, 2)), ("1", np.arange(1, N, 2)))
    b = A.createVecLeft()
    b.setArray(b_np)
    x = A.createVecRight()
    sync()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ksp.setUp()
    sync()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ksp.solve(b, x)
    sync()
    solve_s = time.perf_counter() - t0
    launches = launch_counts()
    its = ksp.getIterationNumber()
    xs = x.getArray()
    rec = {"case": name, "rank": comm.rank, "ranks": comm.size, "backend": comm.backend,
           "n": n, "A_kind": A.meta[0], "its": its,
           "reason": ksp.getConvergedReason().name,
           "history": [float(h) for h in ksp.getConvergenceHistory()],
           "true_relres": float(np.linalg.norm(b_np - A_sp @ xs) / np.linalg.norm(b_np)),
           "levels": dist_levels(ksp), "assembly_s": build_s, "setup_s": setup_s,
           "first_solve_s": solve_s, "launches": {k: launches.get(k, 0) for k in DIST_KERNELS},
           "launches_needed": dist_launches_needed(ksp)}
    if timing:
        comm = A.comm          # the shared operator's (the exchanges count there)
        best, sent0 = None, comm.bytes_sent
        for _ in range(2):
            x2 = A.createVecRight()
            sync()
            t0 = time.perf_counter()
            ksp.solve(b, x2)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            best = ms if best is None else min(best, ms)
        rec["warm_ms_best_of_2"] = best
        rec["bytes_per_it"] = (comm.bytes_sent - sent0) / (2 * max(its, 1))
        if cuda:
            busy, wall = _profile_busy_ms(lambda: ksp.solve(b, A.createVecRight()))
            rec.update(busy_ms=busy, profiled_wall_ms=wall,
                       busy_share=None if busy is None else busy / wall)
            if kind == "grid":
                rec["slab_copy"] = slab_copy_row(A.meta, b.array.dtype)
    return rec, (ksp, A, b, x)


def slab_copy_row(meta, dtype, reps=50):
    """The dnd_mpi product's copy of the rank's slab into its buffer with
    halo planes (mat/aij.py _bind_dnd_mpi), alone: ms a copy by CUDA
    events over `reps` copies, against its bound (the slab read and
    written once at the card's memory rate), in f64 and f32."""
    import torch
    _, P, nzl, shape, _, s = meta
    plane = int(math.prod(shape[1:]))
    out = {}
    for dt in (torch.float64, torch.float32):
        x = torch.rand(nzl * plane, dtype=dt, device="cuda")
        buf = torch.empty((nzl + 2 * s) * plane, dtype=dt, device="cuda")
        buf[s * plane:(s + nzl) * plane] = x
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        ev0.record()
        for _ in range(reps):
            buf[s * plane:(s + nzl) * plane] = x
        ev1.record()
        torch.cuda.synchronize()
        nbytes = 2 * x.numel() * x.element_size()
        out[str(dt).split(".")[1]] = {"ms": ev0.elapsed_time(ev1) / reps, "bytes": nbytes,
                                      "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
                                      "slab_planes": nzl, "plane": list(shape[1:])}
    return out


def dist_check(rec, want, cycle):
    """The contract of a phase dist case on one rank: its and reason equal,
    the history to DIST_HIST_TOL, the levels' rows and sharded kinds
    equal, the true relres at most DIST_RELRES_FACTOR times the
    reference's, the launches exactly the formula's."""
    import numpy as np
    name = rec["case"]
    if (rec["its"], rec["reason"]) != (want["its"], want["reason"]):
        raise AssertionError(f"dist {name} rank {rec['rank']}: its/reason {rec['its']} "
                             f"{rec['reason']}, the reference {want['its']} {want['reason']}")
    h, hj = np.asarray(rec["history"]), np.asarray(want["history"])
    tol = DIST_HIST_TOL[cycle]
    if h.shape != hj.shape or not np.all(np.abs(h - hj) <= tol * np.maximum(hj, 1e-6 * hj[0])):
        raise AssertionError(f"dist {name} rank {rec['rank']}: history off the reference's "
                             f"by {np.max(np.abs(h - hj) / hj)} (tol {tol})")
    lv, lvj = rec["levels"], [tuple(l) for l in want["levels"]]
    if [r for _, r in lv] != [r for _, r in lvj] or any(
            k != kj for (k, _), (kj, _) in zip(lv, lvj) if kj in ("mpiaij", "dnd_mpi")):
        raise AssertionError(f"dist {name} rank {rec['rank']}: levels {lv}, the reference {lvj}")
    if rec["A_kind"] != want["A_kind"]:
        raise AssertionError(f"dist {name}: layout {rec['A_kind']}, the reference's "
                             f"{want['A_kind']}")
    if not rec["true_relres"] <= DIST_RELRES_FACTOR * want["true_relres"]:
        raise AssertionError(f"dist {name} rank {rec['rank']}: true relres "
                             f"{rec['true_relres']} > {DIST_RELRES_FACTOR} x "
                             f"{want['true_relres']}")
    need = rec["launches_needed"]
    got = {k: v for k, v in rec["launches"].items() if v}
    if got != need:
        raise AssertionError(f"dist {name} rank {rec['rank']}: launches {got}, need {need}")


def gloo_cuda_probe():
    """Which gloo collectives take CUDA tensors themselves in this PyTorch build
    (each tried once on every rank): the port's transport hands them CUDA
    tensors as they are (parallel/mesh.py), so each must."""
    import torch
    import torch.distributed as dist
    P = dist.get_world_size()
    t = torch.ones(4, dtype=torch.float64, device="cuda")
    tries = {
        "all_reduce": lambda: dist.all_reduce(t.clone()),
        "all_gather": lambda: dist.all_gather([torch.empty_like(t) for _ in range(P)], t),
        "all_to_all_single": lambda: dist.all_to_all_single(torch.empty(P, dtype=t.dtype,
                                                                        device=t.device),
                                                            torch.ones(P, dtype=t.dtype,
                                                                       device=t.device)),
        "broadcast": lambda: dist.broadcast(t.clone(), 0),
    }
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "takes CUDA tensors"
        except (RuntimeError, TypeError, ValueError) as e:   # a probe: the answer is the message
            out[name] = f"refused: {str(e).splitlines()[0][:160]}"
        dist.barrier()
    return out


def _dist_rank(rank, size, store, results):
    """One rank of phase dist: a gloo group over the file store, the probe,
    then every DIST_CASES case against the contract; its records go to the
    parent. An error ends the process with a non-zero code (no try)."""
    import datetime
    import os
    import torch
    import torch.distributed as dist
    os.environ["RANK"] = os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=DIST_GROUP_TIMEOUT_S))
    import petsc_tpu_torch as pt
    out = {"rank": rank, "gloo_cuda": gloo_cuda_probe(), "cases": {}}
    contract, cache = dist_contract(), {}
    for name, (n, kind, opts) in DIST_CASES.items():
        rec, _ = dist_case(pt, name, n, kind, opts, cache=cache)
        dist_check(rec, contract[name], "f32" if name.endswith("f32") else "f64")
        out["cases"][name] = rec
    cache.clear()
    results.put(out)
    dist.barrier()
    dist.destroy_process_group()


def _nccl_one_rank(store, results):
    """A one-rank NCCL group: each collective of the port's exchange and
    reductions on CUDA tensors at the main path's shapes and types
    (all_reduce of dot2's pair and of a coarse vector, all_to_all_single of
    a 128^2 halo plane, all_gather of a coarse level's planes), checked."""
    import datetime
    import torch
    import torch.distributed as dist
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=DIST_GROUP_TIMEOUT_S))
    torch.cuda.set_device(0)
    g = torch.Generator(device="cuda").manual_seed(5)
    out = {"backend": str(dist.get_backend())}
    for dt in (torch.float64, torch.float32):
        pair = torch.rand(2, generator=g, device="cuda", dtype=torch.float64).to(dt)
        red = pair.clone()
        dist.all_reduce(red)
        plane = torch.rand(128 * 128, generator=g, device="cuda", dtype=torch.float64).to(dt)
        recv = torch.empty_like(plane)
        dist.all_to_all_single(recv, plane, [plane.numel()], [plane.numel()])
        planes = torch.rand(27 * 2 * 8 * 8, generator=g, device="cuda",
                            dtype=torch.float64).to(dt)
        parts = [torch.empty_like(planes)]
        dist.all_gather(parts, planes)
        coarse = torch.rand(56, generator=g, device="cuda", dtype=torch.float64).to(dt)
        cred = coarse.clone()
        dist.all_reduce(cred)
        torch.cuda.synchronize()
        ok = {"all_reduce_pair": bool(torch.equal(red, pair)),
              "all_to_all_single_plane": bool(torch.equal(recv, plane)),
              "all_gather_planes": bool(torch.equal(parts[0], planes)),
              "all_reduce_coarse": bool(torch.equal(cred, coarse))}
        if not all(ok.values()):
            raise AssertionError(f"one-rank NCCL collectives ({dt}): {ok}")
        out[str(dt).split(".")[1]] = ok
    results.put(out)
    dist.destroy_process_group()


def _run_ranks(target, nprocs, args, wall_s):
    """Start nprocs spawned processes on target(rank, *args, queue) (or, for
    one process, target(*args, queue)), collect one result each, join every
    process and check its exit code; a rank that dies or a wait past wall_s
    stops the others and fails the phase."""
    import queue as _queue
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=((r,) if nprocs > 1 else ()) + args + (q,))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    got, t_end = [], time.perf_counter() + wall_s
    try:
        while len(got) < nprocs:
            try:
                got.append(q.get(timeout=5))
            except _queue.Empty:
                bad = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if bad or time.perf_counter() > t_end:
                    raise AssertionError(f"phase dist: a rank failed (exit codes "
                                         f"{[p.exitcode for p in procs]}) or the wait "
                                         f"passed {wall_s} s")
        for p in procs:
            p.join(timeout=120)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise AssertionError(f"phase dist: exit codes {codes}")
    return got


def phase_dist(smi, t_start):
    """DIST_RANKS gloo ranks on the one card run DIST_CASES against the
    contract (each rank checks its its, reason, history, levels, true
    relres and exact launches); then a one-rank NCCL group runs the
    collectives on CUDA tensors."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ptt_dist_") as d:
        ranks = _run_ranks(_dist_rank, DIST_RANKS, (DIST_RANKS, f"{d}/gloo"), DIST_WALL_S)
        nccl = _run_ranks(_nccl_one_rank, 1, (f"{d}/nccl",), 300)[0]
    ranks.sort(key=lambda o: o["rank"])
    refused = {k: v for k, v in ranks[0]["gloo_cuda"].items() if v != "takes CUDA tensors"}
    if refused:
        raise AssertionError(f"phase dist: gloo refuses CUDA tensors in {refused}")
    contract = dist_contract()
    cases = {}
    for name in DIST_CASES:
        recs = [o["cases"][name] for o in ranks]
        if len({r["its"] for r in recs}) != 1:
            raise AssertionError(f"dist {name}: the ranks' its differ: {[r['its'] for r in recs]}")
        cases[name] = {
            "its": recs[0]["its"], "reason": recs[0]["reason"], "A_kind": recs[0]["A_kind"],
            "levels": recs[0]["levels"], "contract_its": contract[name]["its"],
            "contract_seconds_cpu_jax": contract[name]["seconds"],
            "true_relres": recs[0]["true_relres"],
            "contract_true_relres": contract[name]["true_relres"],
            "per_rank": [{k: r.get(k) for k in ("rank", "backend", "assembly_s", "setup_s",
                                                   "first_solve_s", "warm_ms_best_of_2",
                                                   "busy_ms", "profiled_wall_ms", "busy_share",
                                                   "bytes_per_it", "slab_copy",
                                                   "launches")} for r in recs]}
    return {"phase": "dist", "ranks": DIST_RANKS, "backend": "gloo",
            "note": f"{DIST_RANKS} ranks (processes) share one card: {smi}",
            "nvidia_smi": smi, "gloo_cuda_collectives": ranks[0]["gloo_cuda"],
            "nccl_one_rank": nccl, "cases": cases, "seconds": time.perf_counter() - t0,
            "seconds_so_far": time.perf_counter() - t_start}, \
        {name: [o["cases"][name]["launches"] for o in ranks] for name in DIST_CASES}


def main_dist_only():
    """``--phase dist``: the build, then phase dist alone (about 5 minutes
    on one H100), its record as the last line, the card's name and power
    limit before it."""
    from petsc_tpu_torch import native
    from petsc_tpu_torch.ops import cuda_build, pallas_kernels
    t0 = time.perf_counter()
    cuda_build.library()
    pallas_kernels.kernels_available("cuda")
    native.lib()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    emit({"phase": "build", "seconds": time.perf_counter() - t0})
    rec, _ = phase_dist(smi, t0)
    print(smi, flush=True)
    emit(rec)
    return 0


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of petsc_tpu_torch on one GPU.")
    ap.add_argument("--phase", choices=("all", "dist"), default="all",
                    help="all: every phase and the contract's last line (the default); "
                         "dist: the build and phase dist alone")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing was run",
              file=sys.stderr)
        return 2
    if args.phase == "dist":
        return main_dist_only()
    import petsc_tpu_torch as pt
    from petsc_tpu_torch import native
    from petsc_tpu_torch.ops import cuda_build, stencil_build as sb
    from petsc_tpu_torch.ops import gather_kernels as gk
    from petsc_tpu_torch.ops import grid_kernels as gridk
    from petsc_tpu_torch.ops import pallas_kernels as pk

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    earlier_build = start_earlier_build()     # beside the package's nvcc processes
    try:
        cuda_build.library()
        pk.kernels_available("cuda")
        torch.cuda.synchronize()
    except BaseException:
        stop_earlier_build(earlier_build)       # leave no nvcc running
        raise
    log = (cuda_build.library_path().parent / "nvcc.log")
    ptxas = ([ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
             if log.exists() else [])
    nvcc_s = time.perf_counter() - t0
    earlier, earlier_s = load_earlier(earlier_build)
    t0 = time.perf_counter()
    native.lib()
    emit({"phase": "build", "seconds": nvcc_s, "nvcc_seconds": cuda_build.build_seconds,
          "earlier_designs_seconds": earlier_s,
          "ptxas": ptxas, "native_seconds": time.perf_counter() - t0,
          "native_build_seconds": native.build_seconds, "native_openmp": native.openmp})

    triad_Bps = pk.streams_triad_bandwidth(n=1 << 25, dtype=torch.float64, reps=20) * 1e9
    flush = L2Flush()
    details, main_rows = phase_kernels(pk, sb, flush, triad_Bps)
    emit({"phase": "kernels", "triad_GBs_f64": triad_Bps / 1e9, "nvidia_smi": smi,
          "flush": "clean", "checks": details})
    dirty = L2Flush(clean=False)
    emit({"phase": "flush", "nvidia_smi": smi,
          "rows": phase_flush(pk, {"dirty": dirty, "clean": flush})})
    del dirty

    # ---- the main path, with every launch count set to 0 just before ----
    torch.cuda.reset_peak_memory_stats()
    live0 = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    ksp, A, b, x = solve_once(pt, sb, "jacobi")
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = launch_counts()
    its, reason, relres, true_rel = check_solve(pk, ksp, b, x)
    hist_stencil = ksp.getConvergenceHistory()
    need = {"probe": 1, "const_stencil": its, "triad": its, "axpy_normsq": its, "dot2": its}
    short = {k: (launches[k], v) for k, v in need.items() if launches[k] < v}
    if short:
        raise AssertionError(f"main path launched too few kernels (got, need): {short}")
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    path_mb = (torch.cuda.max_memory_allocated() - live0) / 2 ** 20
    jac_ms = warm_ms(ksp, b, x)
    check_solve(pk, ksp, b, x)

    ksp_none, _, b2, x2 = solve_once(pt, sb, "none")
    none = check_solve(pk, ksp_none, b2, x2)
    hist_stencil_none = ksp_none.getConvergenceHistory()
    none_ms = warm_ms(ksp_none, b2, x2)
    check_solve(pk, ksp_none, b2, x2)
    emit({"phase": "solve", "n": N_MAIN, "stencil": "box27", "dtype": "float64",
          "rtol": 1e-8, "nvidia_smi": smi,
          "jacobi": {"its": its, "reason": reason, "relres": relres,
                     "true_relres": true_rel, "first_solve_s_incl_init": main_s,
                     "warm_ms_best_of_3": jac_ms, "ms_per_it": jac_ms / its,
                     "launches": launches,
                     "launches_per_it": {k: v / its for k, v in launches.items()},
                     "peak_mem_MiB": peak_mb, "path_peak_mem_MiB": path_mb},
          "none": {"its": none[0], "reason": none[1], "relres": none[2],
                   "true_relres": none[3], "warm_ms_best_of_3": none_ms,
                   "ms_per_it": none_ms / none[0]},
          "seconds_so_far": time.perf_counter() - t_start})
    prof = profile_solve(ksp, b, x, jac_ms)
    emit({"phase": "profile", "solve": "jacobi", "nvidia_smi": smi, **prof})
    check_solve(pk, ksp, b, x)
    check_one_launch(prof, its)

    gdetails, gather_rows = phase_gather(gk, flush)
    emit({"phase": "gather", "nvidia_smi": smi, "checks": gdetails,
          "seconds_so_far": time.perf_counter() - t_start})

    # ---- the assembled-matrix path, with every launch count set to 0 just before ----
    t0 = time.perf_counter()
    ci, cj, cv = box27_coo(N_MAIN)
    coo_s = time.perf_counter() - t0
    pt.init(args=["-ksp_type", "cg", "-pc_type", "jacobi", "-ksp_rtol", "1e-8",
                  "-ksp_max_it", "3000"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live0 = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    A_aij = pt.MatAIJ()
    A_aij.setSizes(N_MAIN ** 3)
    t1 = time.perf_counter()
    A_aij.setPreallocationCOO(ci, cj)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    A_aij.setValuesCOO(cv)
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t1
    ksp_a, b_a, x_a = aij_solve(pt, A_aij, "jacobi")
    torch.cuda.synchronize()
    aij_s = time.perf_counter() - t0
    aij_launches = launch_counts()
    del ci, cj
    emit({"phase": "aij_host", "coo_generate_s": coo_s, "setPreallocationCOO_s": pre_s,
          "setValuesCOO_s": val_s})
    if A_aij.meta[0] != "aij_csr" or A_aij.nnz() != NNZ_MAIN:
        raise AssertionError(f"assembled 128^3 box27: kind {A_aij.meta[0]}, nnz {A_aij.nnz()}")
    jac_a = check_aij_solve(pk, ksp_a, A_aij, b_a, x_a, hist_stencil)
    its_a = jac_a["its"]
    need = {"gather": 2, "csr_spmv": its_a, "triad": its_a, "axpy_normsq": its_a,
            "dot2": its_a}
    short = {k: (aij_launches[k], v) for k, v in need.items() if aij_launches[k] < v}
    if short or aij_launches["const_stencil"] != 0:
        raise AssertionError(f"assembled path's launches (got, need): {short}; "
                             f"const_stencil {aij_launches['const_stencil']} (need 0)")
    peak_a = torch.cuda.max_memory_allocated() / 2 ** 20
    path_a = (torch.cuda.max_memory_allocated() - live0) / 2 ** 20
    coo_rows = phase_coo_gather(gk, A_aij, cv, flush)
    del cv
    jac_ms_a = warm_ms(ksp_a, b_a, x_a)
    check_aij_solve(pk, ksp_a, A_aij, b_a, x_a, hist_stencil)
    ksp_n, b_n, x_n = aij_solve(pt, A_aij, "none")
    none_a = check_aij_solve(pk, ksp_n, A_aij, b_n, x_n, hist_stencil_none)
    none_ms_a = warm_ms(ksp_n, b_n, x_n)
    check_aij_solve(pk, ksp_n, A_aij, b_n, x_n, hist_stencil_none)
    sdetails, spmv_row = phase_spmv(pt, pk, sb, A_aij, flush)
    emit({"phase": "aij", "n": N_MAIN, "stencil": "box27", "assembly": "COO",
          "kind": A_aij.meta[0], "nnz": A_aij.nnz(), "dtype": "float64", "rtol": 1e-8,
          "nvidia_smi": smi,
          "jacobi": {**jac_a, "first_assembly_and_solve_s": aij_s,
                     "warm_ms_best_of_3": jac_ms_a, "ms_per_it": jac_ms_a / its_a,
                     "launches": aij_launches,
                     "launches_per_it": {k: v / its_a for k, v in aij_launches.items()},
                     "peak_mem_MiB": peak_a, "path_peak_mem_MiB": path_a},
          "none": {**none_a, "warm_ms_best_of_3": none_ms_a,
                   "ms_per_it": none_ms_a / none_a["its"]},
          "spmv": sdetails, "coo_gather": coo_rows,
          "seconds_so_far": time.perf_counter() - t_start})
    prof_a = profile_solve(ksp_a, b_a, x_a, jac_ms_a)
    emit({"phase": "aij_profile", "solve": "jacobi", "nvidia_smi": smi, **prof_a})
    check_aij_solve(pk, ksp_a, A_aij, b_a, x_a, hist_stencil)
    check_one_launch(prof_a, its_a)

    # ---- CG + PCMG on the assembled operator, f64 and f32 cycles ----
    mg_rec, ksp_m, b_m, x_m, mg_ms, mg_launches = phase_mg(pt, pk, A_aij, smi, t_start,
                                                                flush)
    cheby_rows, cheby_main = phase_cheby(pk, flush)
    mg_rec["cheby_update_checks"] = cheby_rows
    emit(mg_rec)
    prof_m = profile_solve(ksp_m, b_m, x_m, mg_ms)
    emit({"phase": "mg_profile", "solve": "cg+pcmg, f64 cycle", "nvidia_smi": smi, **prof_m,
          "seconds_so_far": time.perf_counter() - t_start})
    check_mg_solve(pk, ksp_m, A_aij, b_m, x_m, "f64")
    del ksp_m, b_m, x_m

    # ---- CG + GAMG on the assembled operator, f64 and f32 cycles ----
    gamg_rec, ksp_g, b_g, x_g, gamg_ms, gamg_launches = phase_gamg(pt, pk, A_aij, smi,
                                                                   t_start, flush)
    emit(gamg_rec)
    prof_g = profile_solve(ksp_g, b_g, x_g, gamg_ms)
    emit({"phase": "gamg_profile", "solve": "cg+gamg, f64 cycle", "nvidia_smi": smi, **prof_g,
          "seconds_so_far": time.perf_counter() - t_start})
    check_gamg_solve(pk, ksp_g, A_aij, b_g, x_g, "f64")
    del ksp_g, b_g, x_g

    # ---- the rest of the core surface on the card, on the assembled operator ----
    emit(phase_surface(pt, pk, A_aij, hist_stencil, smi, t_start))

    # ---- MatMAIJ and MatKAIJ on the assembled operator (M1) ----
    mk_rec, mk_launches, mk_prof, m1_main = phase_maij_kaij(pt, pk, A_aij, smi, t_start,
                                                            flush, earlier)
    emit(mk_rec)
    del A_aij
    torch.cuda.empty_cache()

    # ---- MatShell, Mat.createStencil and matSolve's MatDense on the main path ----
    sd_rec, sd_launches, sd_prof = phase_mat_shell_dense(pt, pk, sb, smi, t_start)
    emit(sd_rec)

    # ---- CG + GAMG with the structured head on the stencil operator (bench.py's
    # solve), f32 and f64 cycles ----
    grid_rec, grid_main, grid_res = phase_gamg_grid(pt, pk, gridk, sb, smi, t_start, flush,
                                                    jac_ms, earlier)
    emit(grid_rec)
    prof_grid = {}
    for cycle in ("f32", "f64"):
        ksp_q, b_q, x_q, ms_q, _ = grid_res[cycle]
        q1_levels = [lev.A.meta[1] for lev in ksp_q.getPC()._impl.levels[:-1]
                     if lev.P.meta[0] == "interp_q1"]
        prof_grid[cycle] = profile_solve(ksp_q, b_q, x_q, ms_q, q1_levels)
        emit({"phase": "gamg_grid_profile", "solve": f"cg+gamg structured, {cycle} cycle",
              "nvidia_smi": smi, **prof_grid[cycle],
              "seconds_so_far": time.perf_counter() - t_start})
        check_gamg_grid_solve(pk, ksp_q, b_q, x_q, cycle)
    grid_launches = grid_res["f32"][4]
    grid_launches_f64 = grid_res["f64"][4]
    del grid_res, ksp_q, b_q, x_q
    torch.cuda.empty_cache()

    # ---- BASELINE config 2: GMRES(30) + ILU(0), PETSc's defaults, on the
    # assembled 22 x 239 x 239 stencil7 ----
    gm_rec, gm_solve, gm_ms, gm_launches, t_rows, t_main = phase_gmres_ilu(
        pt, smi, t_start, flush, earlier)
    emit(gm_rec)
    ksp_gm, b_gm, x_gm = gm_solve[:3]
    reset_launches()
    prof_gm = profile_solve(ksp_gm, b_gm, x_gm, gm_ms)
    prof_launches = launch_counts()
    t1_in = prof_gm["in_solve"].get("trisolve", {})
    nlev = gm_rec["levels"]
    prof_gm["trisolve_us_per_level"] = (t1_in["us_per_launch"] / ((nlev["L"] + nlev["U"]) / 2)
                                        if t1_in else None)
    emit({"phase": "gmres_ilu_profile", "solve": "gmres(30)+ilu(0), config 2",
          "nvidia_smi": smi, **prof_gm, "launches": prof_launches,
          "its": ksp_gm.getIterationNumber(),
          "seconds_so_far": time.perf_counter() - t_start})
    check_config2(*gm_solve, GMRES_ITS, "CONVERGED_RTOL", GMRES_HIST, GMRES_TRUE_RELRES,
                  GMRES_MAX_ERR)
    if not prof_launches["trisolve"] == t1_in.get("launches") == 2 * (GMRES_ITS + 1):
        raise AssertionError(f"the profiled solve: {prof_launches['trisolve']} T1 sweeps "
                             f"counted, {t1_in.get('launches')} in the profile, want "
                             f"{2 * (GMRES_ITS + 1)}")
    del gm_solve, ksp_gm, b_gm, x_gm
    torch.cuda.empty_cache()

    # ---- PETSc's ex56 (BAIJ, bs 3, GAMG with six rigid-body modes): the
    # defaults at ne 64, the reference's knob set at ne 11 and 24 ----
    (ex_rec, b1_main, a1_main, c1z_main, a1c_main, ex_launches, ex_prof, exk_launches,
     exk_prof, ne64) = phase_ex56(pt, smi, t_start, flush, earlier)
    emit(ex_rec)

    # ---- ex56's ne 64 operator as a MatSBAIJ (its upper triangle), with the
    # same GAMG solve ----
    sb_rec, sb_launches, sb_prof = phase_sbaij(pt, ne64, smi, t_start)
    emit(sb_rec)
    ex56_op = ne64[:2]           # the CSR and b, for phase pc's fieldsplit case
    del ne64

    # ---- PETSc's ex45 (DMDA, KSP.setDM, PCMG from the DM and GAMG) at 129^3,
    # the dof-3 PCMG at 65^3, Q1P/Q1R at dof 2 and 3, the tutorials ----
    ex45_rec, q1_dof, ex45_launches, ex45_prof = phase_ex45(pt, gridk, smi, t_start, flush)
    emit(ex45_rec)

    # ---- the Krylov types of item 8 against their contracts: config 2
    # assembled (ILU(0)), on its grid (V1, V1T) and under mixed precision;
    # the 128^3 box27 stencil (S1) ----
    kr_rec, v1t_main, kr_launches, kr_grid_launches = phase_krylov(pt, smi, t_start, flush)
    emit(kr_rec)
    torch.cuda.empty_cache()

    # ---- the PC types of item 8 against their contracts: config 2 (ASM,
    # the Neumann trisolve, bjacobi), the 128^3 box27 CSR (composite, PCKSP,
    # classical GAMG), ex56 ne 64 (fieldsplit), the ex59-class MatIS (BDDC,
    # fetidp, NN); X1, D1 and N1 on the path's tables ----
    pc_rec, pc_rows, pc_launches, pc_case_launches = phase_pc(pt, smi, t_start, flush, ex56_op,
                                                              gm_ms, earlier)
    emit(pc_rec)
    del ex56_op
    torch.cuda.empty_cache()

    # ---- SNES, TS and Tao (item 10): each case with every launch count set
    # to 0 just before its first run and read just after ----
    nl_rec, nl_launches = phase_nonlinear(pt, smi, t_start)
    emit(nl_rec)

    # ---- DMPlex, PetscFE/DS and FV on Plex (item 11, first half): PETSc's
    # SNES ex12, PCMG on a refined plex, second-order FV advection; each
    # case with every launch count set to 0 just before its first run and
    # read just after; X1's add, signed and min modes on their tables ----
    plex_rec, plex_launches, plex_x1 = phase_plex(pt, smi, t_start, flush, earlier)
    emit(plex_rec)

    # ---- the rest of DM and item 13 (I/O, PF, Random, ML): the MAC Stokes
    # system at 64 and 512, the 2-D and 3-D swarms (W1, W2), the network
    # KCL, the LETKF, the regressor, PF, Random, binary and VTK files; each
    # case with every launch count set to 0 just before its first run and
    # read just after; W1 and W2 on the swarms' shapes ----
    dm_rec, dm_launches, cic = phase_dm_more(pt, smi, t_start, flush, earlier)
    emit(dm_rec)

    # ---- bench.py's keys from the card: bench_gpu.py in a process of its own ----
    bench = phase_bench_gpu(smi, t_start)

    # ---- distribution over ranks (item 12's linear-algebra half): 4 gloo
    # ranks sharing the card, each case with every launch count set to 0
    # just before its assembly and read after its first solve; a one-rank
    # NCCL group for the collectives on CUDA tensors ----
    dist_rec, dist_launches = phase_dist(smi, t_start)
    emit(dist_rec)

    # name: (source, replaces, measured row, launches on the path it belongs to)
    rows = {
        "probe": ("probe.cu", "petsc_tpu/ops/pallas_kernels.py:31", main_rows, launches),
        "triad": ("triad.cu", "petsc_tpu/ops/pallas_kernels.py:108", main_rows, launches),
        "axpy_normsq": ("axpy_normsq.cu", "petsc_tpu/ops/pallas_kernels.py:151", main_rows,
                        launches),
        "dot2": ("dot2.cu", "petsc_tpu/ops/pallas_kernels.py:198", main_rows, launches),
        "const_stencil": ("const_stencil.cu", "petsc_tpu/mat/aij.py:1346", main_rows,
                          launches),
        "csr_spmv": ("csr_spmv.cu", "petsc_tpu/mat/aij.py:1554", {"csr_spmv": spmv_row},
                     aij_launches),
        "lane_shuffle": ("lane_shuffle.cu", "examples/pallas_shuffle_probe.py:60",
                         gather_rows, aij_launches),
        "row_gather": ("row_gather.cu", "examples/pallas_shuffle_probe.py:92",
                       gather_rows, aij_launches),
        "gather2": ("gather.cu", "examples/pallas_shuffle_probe.py:125", gather_rows,
                    aij_launches),
        "gather": ("gather.cu", "examples/pallas_gather_probe.py:50",
                   {"gather": coo_rows[0]}, aij_launches),
        "cheby_update": ("cheby.cu", "petsc_tpu/ksp/cheby.py:40", {"cheby_update": cheby_main},
                         mg_launches),
        "dnd_stencil": ("dnd_stencil.cu", "petsc_tpu/mat/aij.py:1381", grid_main, grid_launches),
        "q1_prolong": ("q1.cu", "petsc_tpu/dm/interp.py:21", grid_main, grid_launches),
        "q1_restrict": ("q1.cu", "petsc_tpu/dm/interp.py:49", grid_main, grid_launches),
        "trisolve": ("trisolve.cu", "petsc_tpu/ops/trisolve.py:94", {"trisolve": t_main},
                     gm_launches),
        "bsr_spmv": ("bsr_spmv.cu", "petsc_tpu/mat/aij.py:1494", {"bsr_spmv": b1_main},
                     ex_launches),
        "agg_block_apply": ("agg_block.cu", "petsc_tpu/pc/mg.py:516",
                            {"agg_block_apply": a1_main}, exk_launches),
        "cheby_update_z": ("cheby.cu", "petsc_tpu/ksp/cheby.py:42",
                           {"cheby_update_z": c1z_main}, exk_launches),
        "agg_block_cheby": ("agg_block.cu", "petsc_tpu/pc/mg.py:516",
                            {"agg_block_cheby": a1c_main}, exk_launches),
        "csr_spmm": ("csr_spmm.cu", "petsc_tpu/mat/utility.py:356", {"csr_spmm": m1_main},
                     mk_launches["maij"]),
        "dnd_stencil_t": ("dnd_stencil.cu", "petsc_tpu/mat/aij.py:1438",
                          {"dnd_stencil_t": v1t_main}, kr_grid_launches),
        "dst_scatter": ("dst_scatter.cu", "petsc_tpu/pc/bddc.py:138",
                        {"dst_scatter": pc_rows["dst_scatter_add"]}, pc_launches),
        "subdomain_apply": ("subdomain.cu", "petsc_tpu/pc/bddc.py:127",
                            {"subdomain_apply": pc_rows["subdomain_apply_plain"]}, pc_launches),
        "neumann_step": ("neumann_step.cu", "petsc_tpu/pc/factor_pc.py:333",
                         {"neumann_step": pc_rows["neumann_step"]},
                         pc_case_launches["c2_neumann"]),
        "cic_deposit": ("swarm_cic.cu", "petsc_tpu/dm/swarm.py:210",
                        {"cic_deposit": cic["cic_deposit_deposit_swarm_2d"]},
                        dm_launches["swarm_2d"]),
        "cic_interp": ("swarm_cic.cu", "petsc_tpu/dm/swarm.py:233",
                       {"cic_interp": cic["cic_interp_swarm_2d"]}, dm_launches["swarm_2d"]),
    }
    table = []
    for name, (src, replaces, measured, counts) in rows.items():
        r = measured[name]
        table.append({"name": name, "route": "cuda",
                      "source": f"petsc_tpu_torch/csrc/{src}", "replaces": replaces,
                      "launches": counts[name], "max_abs_err": r["max_abs_err"],
                      "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                      "dtype": r["dtype"],
                      "launches_by_path": {"solve": launches[name],
                                           "aij": aij_launches[name],
                                           "mg": mg_launches[name],
                                           "gamg": gamg_launches[name],
                                           "gamg_grid": grid_launches[name],
                                           "gamg_grid_f64": grid_launches_f64[name],
                                           "gmres_ilu": gm_launches[name],
                                           "ex56": ex_launches[name],
                                           "ex56_knobs": exk_launches[name],
                                           "ex45_mg": ex45_launches["mg"][name],
                                           "ex45_gamg": ex45_launches["gamg"][name],
                                           "ex45_dof3": ex45_launches["dof3"][name],
                                           "maij": mk_launches["maij"][name],
                                           "kaij": mk_launches["kaij"][name],
                                           "shell": sd_launches["shell"][name],
                                           "create_stencil":
                                               sd_launches["create_stencil"][name],
                                           "matsolve": sd_launches["matsolve"][name],
                                           "sbaij": sb_launches[name],
                                           "krylov": kr_launches.get(name, 0),
                                           "pc": pc_launches.get(name, 0),
                                           **{f"nonlinear_{c}": v.get(name, 0)
                                              for c, v in nl_launches.items()},
                                           **{f"plex_{c}": v.get(name, 0)
                                              for c, v in plex_launches.items()},
                                           **{f"dm_more_{c}": v.get(name, 0)
                                              for c, v in dm_launches.items()},
                                           **{f"dist_{c}_rank0": v[0].get(name, 0)
                                              for c, v in dist_launches.items()}},
                      "in_solve_us": {path: p["in_solve"].get(name, {}).get("us_per_launch")
                                      for path, p in (("solve", prof), ("aij", prof_a),
                                                      ("mg", prof_m), ("gamg", prof_g),
                                                      ("gamg_grid", prof_grid["f32"]),
                                                      ("gamg_grid_f64", prof_grid["f64"]),
                                                      ("gmres_ilu", prof_gm),
                                                      ("ex56", ex_prof),
                                                      ("ex56_knobs", exk_prof),
                                                      ("ex45_mg", ex45_prof["mg"]),
                                                      ("ex45_gamg", ex45_prof["gamg"]),
                                                      ("maij", mk_prof["maij"]),
                                                      ("kaij", mk_prof["kaij"]),
                                                      ("shell", sd_prof["shell"]),
                                                      ("create_stencil",
                                                       sd_prof["create_stencil"]),
                                                      ("sbaij", sb_prof))},
                      "bench_gpu_launches": {phase: c.get(name, 0)
                                             for phase, c in bench["launches"].items()}})
    for r in table:
        if r["name"] in ("triad", "dot2", "const_stencil"):
            r.update(design=main_rows[r["name"]]["design"],
                     launch=main_rows[r["name"]]["launch"],
                     share_of_bound=r["bound_ms"] / r["ms"])
    # S1's row is the f64 box on the TMA path; the cp.async path, the star
    # and f32 stand beside it
    s1_row = next(r for r in table if r["name"] == "const_stencil")
    s1_row.update(cp_async_path_ms=main_rows["const_stencil"]["cp_async_path_ms"],
                  others=main_rows["const_stencil"]["others"])
    k4 = next(r for r in table if r["name"] == "dot2")
    k4.update(same_bytes_ms=main_rows["dot2"]["same_bytes_ms"],
              same_bytes_call=main_rows["dot2"]["same_bytes_call"])
    # K8's row is timed at the path's v[perm] shape; the diagonal refresh's
    # shape and the probe's stand beside it
    k8 = next(r for r in table if r["name"] == "gather")
    keep = ("ms", "plain_ms", "library_ms", "bound_ms", "bytes", "elements")
    k8["shape"] = coo_rows[0]["shape"]
    k8["diag_refresh_shape"] = {k: coo_rows[1][k] for k in keep + ("shape",)}
    k8["probe_shape"] = {k: gather_rows["gather"][k] for k in keep}
    # S2's row is the f64 product at 128^3; the f32 one stands beside it
    s2 = next(r for r in table if r["name"] == "csr_spmv")
    s2_32 = next(r for r in sdetails if r.get("name") == "csr_spmv" and r["dtype"] == "float32")
    s2.update(tile_entries=spmv_row["tile_entries"], Gnnz_per_s=spmv_row["Gnnz_per_s"],
              share_of_bound=spmv_row["share_of_bound"],
              float32={k: s2_32[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                             "max_abs_err", "Gnnz_per_s", "share_of_bound",
                                             "tile_entries")})
    # C1's row is the f64 step mode at 128^3; the first mode, f32 and the
    # ragged length stand beside it
    c1 = next(r for r in table if r["name"] == "cheby_update")
    c1.update(mode="step", also_replaces="petsc_tpu/ksp/cheby.py:73",
              library="none: no single PyTorch call computes the fused update",
              share_of_bound=cheby_main["share_of_bound"],
              others={f"{r['mode']}_{r['dtype']}_{r['n']}": {
                  k: r[k] for k in ("ms", "plain_ms", "bound_ms", "max_abs_err")}
                  for r in cheby_rows if r is not cheby_main})
    # V1's, Q1P's and Q1R's rows are the f32 cycle's (the main path's) at its
    # 64^3 level (27 planes) and 128^3 <-> 64^3; f64, the other shapes, the
    # generic V1 kernel and the odd sizes stand beside them. earlier_ms is
    # the earlier design's, timed in turns with ms.
    keep = ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err", "equal_bits",
            "earlier_ms", "kernel", "variant")
    for name in ("dnd_stencil", "q1_prolong", "q1_restrict"):
        r = next(r for r in table if r["name"] == name)
        m = grid_main[name]
        r.update(library=m["library"], share_of_bound=m["share_of_bound"],
                 shape=m.get("shape") or m.get("fine"),
                 others=[{**{k: o[k] for k in keep if k in o}, "dtype": o["dtype"],
                          "shape": o.get("shape") or o.get("fine")}
                         for o in grid_rec["kernel_checks"] if o["name"] == name and o is not m])
        if "earlier_ms" in m:
            r.update(earlier_ms=m["earlier_ms"], turns_ms=m["turns_ms"],
                     earlier_share_of_bound=m["earlier_share_of_bound"])
        if name != "dnd_stencil":
            r["in_solve_us_per_level"] = {c: prof_grid[c]["q1_per_level"][name]
                                          for c in ("f32", "f64")}
            r["in_solve_us_per_level"].update(
                {f"ex45_{pc}": ex45_prof[pc]["q1_per_level"][name] for pc in ("mg", "gamg")})
            r["dof"] = [{k: o[k] for k in ("dtype", "fine", "dof", "ms", "plain_ms", "bound_ms",
                                           "share_of_bound", "library_ms", "library",
                                           "library_rel_err", "max_abs_err", "rel_err",
                                           "equal_bits")}
                        for o in q1_dof if o["name"] == name]
    v1 = next(r for r in table if r["name"] == "dnd_stencil")
    v1["ex45_level0"] = {k: ex45_rec["v1_level0"][k]
                         for k in ("dtype", "shape", "planes", "variant", "ms", "plain_ms",
                                   "bound_ms", "share_of_bound", "equal_bits")}
    q1r = next(r for r in table if r["name"] == "q1_restrict")
    q1r.update({k: grid_main["q1_restrict"][k] for k in ("variant", "block", "grid")},
               plan_per_level=grid_rec["q1_restrict_plan_per_level"])
    # T1's row is the forward (unit L) sweep of config 2's ILU(0) in f64;
    # the backward sweep, f32 vectors and the small shapes stand beside it.
    # earlier_ms (the earlier grid-barrier kernel) and grid_ms (the grid
    # variant: the loads ahead, the grid barrier) are timed in turns with ms
    t1 = next(r for r in table if r["name"] == "trisolve")
    keep = ("sweep", "dtype", "factor_dtype", "rows", "entries", "levels", "widest_level",
            "ms", "us_per_level", "plain_ms", "bound_ms", "share_of_bound", "library_ms",
            "library", "equal_bits", "grid_ms", "grid_us_per_level", "earlier_ms",
            "earlier_us_per_level")
    t1.update({k: t_main[k] for k in keep}, launch=t_main["launch"],
              variant=t_main["launch"]["variant"], turns_ms=t_main["turns_ms"],
              grid_launch=t_main["grid_launch"],
              in_solve_us_per_level=prof_gm["trisolve_us_per_level"],
              launches_per_solve=gm_launches["trisolve"],
              design="the plan's variant per sweep: one thread-block cluster (one row of the "
                     "widest level per thread, the cluster's hardware barrier between levels) "
                     "or, wider than a cluster, one cooperative grid with a grid barrier; each "
                     "row's b, scale, first 4 entries and the next level's row pointers "
                     "loaded a level ahead; rows in level order (CSR in level order, int32)",
              without_entries=gm_rec["trisolve_without_entries"],
              cluster_shapes_ms=gm_rec["trisolve_cluster_shapes_ms"],
              others=[{**{k: r[k] for k in keep if k in r}, "variant": r["launch"]["variant"]}
                      for r in t_rows if r is not t_main])
    # B1's row is ex56 ne 64's operator in f64, A1's ex56 ne 24's level-0
    # tables in f64 (its other levels and ne 64's tables beside it); f32,
    # cuSPARSE's note and S2 on the same matrix beside them
    # C1z's is the step_z mode in f64 at the knob set's level-0 length;
    # first_z and f32 beside it; the fused step's is step_z in f64 on ne
    # 24's level-0 tables, the other modes, types and tables beside it
    for name, m in (("bsr_spmv", b1_main), ("agg_block_apply", a1_main),
                    ("cheby_update_z", c1z_main), ("agg_block_cheby", a1c_main)):
        r = next(r for r in table if r["name"] == name)
        r.update({k: m[k] for k in m if k not in r and k != "name"})
        r["others"] = [{k: o[k] for k in ("dtype", "bs", "mode", "shape", "n", "dofs", "max_k",
                                          "ms", "earlier_ms", "plain_ms", "bound_ms",
                                          "library_ms", "library_bsr_ms", "s2_same_matrix_ms",
                                          "max_abs_err", "equal_bits") if k in o}
                       for o in ex_rec[f"{name}_checks"] if o is not m]
    c1z = next(r for r in table if r["name"] == "cheby_update_z")
    c1z.update(also_replaces="petsc_tpu/ksp/cheby.py:36, :79-80",
               library="none: no single PyTorch call computes the fused update",
               status="redesigned: fused into A1 (agg_block_cheby); the standalone "
                      "z modes stay for a smoothing PC without a fused step")
    # M1's row is the MAIJ product on the 128^3 box27 CSR at k = 3 in f64; the
    # other k, f32 and the explicit transpose beside it, each with the earlier
    # design and k launches of S2 on the columns timed in the same turns
    m1 = next(r for r in table if r["name"] == "csr_spmm")
    m1.update({k: m1_main[k] for k in ("operand", "k", "shape", "rel_err", "equal_bits_rerun",
                                       "turns", "turns_ms", "earlier", "earlier_ms",
                                       "earlier_share_of_bound", "s2_per_column_ms",
                                       "share_of_bound", "library", "library_rel_err")},
              also_replaces="petsc_tpu/mat/extra_formats.py:59 (MatKAIJ's A X), "
                            "petsc_tpu/ops/spmv.py:40 (ell_spmm)",
              others=[{k: o[k] for k in ("operand", "k", "dtype", "ms", "earlier_ms",
                                         "s2_per_column_ms", "plain_ms", "bound_ms",
                                         "share_of_bound", "library_ms", "rel_err",
                                         "equal_bits_rerun")}
                      for o in mk_rec["csr_spmm_checks"] if o is not m1_main])
    a1c = next(r for r in table if r["name"] == "agg_block_cheby")
    a1c.update(also_replaces="petsc_tpu/ksp/cheby.py:36-37, :42-43, :79-80 (C1z's step "
                             "tail, as A1's epilogue)",
               library="none: no single PyTorch call computes the product and the step")
    # X1's row is the add mode on the ex59-class MatIS's scatter, D1's the
    # plain form on its Ab; the other modes and forms stand beside them,
    # and the launches of each phase pc case
    for name, main_key, other_keys in (
            ("dst_scatter", "dst_scatter_add", ("dst_scatter_set", "dst_scatter_signed",
                                                "dst_scatter_long")),
            ("subdomain_apply", "subdomain_apply_plain", ("subdomain_apply_kqq",
                                                          "subdomain_apply_phi",
                                                          "subdomain_apply_transposed")),
            ("neumann_step", "neumann_step", ())):
        r = next(r for r in table if r["name"] == name)
        m = pc_rows[main_key]
        r.update({k: m[k] for k in m if k not in r and k != "name"})
        r["others"] = [pc_rows[k] for k in other_keys]
        r["launches_by_pc_case"] = {c: v.get(name, 0) for c, v in pc_case_launches.items()}
        if name == "dst_scatter":
            # phase plex's tables: the DS residual's add, FVPlex's signed
            # fluxes and its limiter's min mode
            r["plex_rows"] = list(plex_x1.values())
            r["also_replaces"] = ("petsc_tpu/dm/fe.py:1403 (add), "
                                  "petsc_tpu/dm/fv_plex.py:245-246 (signed), "
                                  "petsc_tpu/dm/fv_plex.py:225-227 (min)")
    # W1's row is depositSum on the 2-D swarm (16,777,216 particles, 1025^2
    # nodes), W2's interpolateToParticles there; projectFields' launch and
    # the 3-D swarm stand beside them
    for name, main_key in (("cic_deposit", "cic_deposit_deposit_swarm_2d"),
                           ("cic_interp", "cic_interp_swarm_2d")):
        r = next(r for r in table if r["name"] == name)
        m = cic[main_key]
        r.update({k: m[k] for k in m if k not in r and k != "name"})
        r["others"] = [v for k, v in cic.items() if v["name"] == name and k != main_key]
        r["also_replaces"] = ("petsc_tpu/dm/swarm.py:166-208 (projectFields)"
                              if name == "cic_deposit" else "")
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
