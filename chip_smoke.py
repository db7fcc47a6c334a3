#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (`phiflow_tpu_torch`) on one NVIDIA card and check it.

    python3 chip_smoke.py           # all phases, one card
    python3 chip_smoke.py --quick   # build + kernel-versus-twin checks at the small shapes only (and 9a)
    python3 chip_smoke.py --profile # all phases, then torch.profiler over 3 steps of each path (4-field too,
                                    # Burgers 128² and Kolmogorov 512² Field and native steps, both SPH and
                                    # both FVM sizes, a call of grad-256's and grad-4096-2d's gradient),
                                    # K2 and K3 at every level of the 256³ V-cycle, K1 at 256³ and
                                    # K1m at 256³ (obstacle masks) and 128³ (active) with each x-chunk

Phases; any failure exits non-zero and prints no result:
  1. the card's name and power limit (nvidia-smi) and the torch / CUDA versions;
  2. the build of phiflow_tpu_torch/csrc/*.cu with nvcc, one process per source, with
     ptxas's registers and spills of each instantiation of K1's and K6/K7's kernels and of K8's two,
     each of K6ᵀ / K7ᵀ's three (d_disp's, d_grid's and the wide d_grid's) with its stack frame —
     0 bytes and no spills, or the phase fails —,
     and beside them the mesh face matcher phiflow_tpu_torch/native/meshbuild.cpp with g++;
  3. each kernel K1–K8 and the masked forms of K1 (K1m: active cells; the
     coefficient arrays of obstacles) against its plain
     PyTorch twin on the card, at a shape of its path (256³; 4096² for K7; 128³
     and 64³ with 1.06 M and 125 k particles for K8 and K1m; 256³ with the
     obstacle path's own masks for K1m's coefficient form) and at a small
     shape that is not a power of two, over the three boundary modes, float32
     and bfloat16 where the path stores it (K2 also at one narrower than 64 in
     z, its second tile; K1, K1m, K3 and K4 also at a z that is no whole
     number of 16-byte groups, their scalar path, and K1, K1m and K3 at one
     narrower than a warp's runs, and K3 at the level shapes of the 48³
     obstacle V-cycle, with p / u and b in either dtype; K1m in its three forms
     × three epilogues, each with and without the dot; K6 also at rows of 262
     and 264, scalar and float4, with blocks inside the grid and on its
     border in the padded and the raw layout; K8 and its mean (`p2g_mean`)
     also with every particle in one cell and integer values, exact; with
     NaN and infinite values on dropped particles and NaN values on kept ones;
     at a particle count that is no multiple of a warp; on the FLIP sets in
     the path's order and shuffled, onto the four target grids; the mean of a
     call bit-equal to the twin's formula on that call's sums and counts;
     K6ᵀ / K7ᵀ against the twin's VJP in every halo form at K = 1 and 2 with
     and without the extrema, and at the K of the one-slot-plane route (6 in
     3D, 24 in 2D) and past the slot window (the wide kernel: 8 in 3D, 33
     in 2D), on wrapped axes of at most 2K cells and with NaN displacements
     (JAX's rule there: the twin's NaN pattern, as for K5, K6 and K7),
     every form launched twice and bit-equal; empty outputs give
     zeros with no launch counted); K5, K6, K7, K6ᵀ, K7ᵀ and the wide kernel
     on grids holding NaN, +inf and -inf (`check_grid_nonfinite`: the NaN
     and ±inf patterns of the twins, which follow JAX's window sum, every
     halo form, a padded grid's halo, a NaN constant halo, and a finite call
     after the non-finite ones: the kernels' flag lowered again; K6ᵀ / K7ᵀ
     also with the forward's verdict, as autograd runs them, and on a grid
     whose one bad cell only d_disp's own-cell test used to find); the
     median CUDA-event time of the
     kernel, of the twin and, where one PyTorch call computes the same
     function, of that call (library_ms — the port never calls it), beside the
     bound: the larger of bytes moved / 3.35 TB/s and float32 operations /
     67 TFLOP/s (H100 SXM data sheet); and the kernel's and the library's
     time on the device alone, replayed from a CUDA graph (device_ms,
     library_device_ms), without the wrapper's host time. K5 is timed per
     call and for a step's three calls, K2 for a 256³ level's pair of
     smooths, K4 at 128³ in float32 too; and K2 (each smooth), K3 and K4 at
     every level of the 256³ V-cycle in its dtypes, each checked against its
     twin there first, with their launches × (device − bound) summed a
     V-cycle and a step beside K1's; K8's sums + counts (beside two
     `index_add_`) and its whole mean (beside one `index_reduce_` mean) onto
     the x faces and the cells at 128³ and 64³, on the particles of the
     path's first step in its order, and at 128³ shuffled;
  4. eight paths on the card, each (but 4g) 2 warm-up steps, then 5 timed steps with
     every launch counter set to 0 just before and read just after. The
     models' paths run their Field face — `initial_state()` and `step(...)`
     on Fields, as JAX's users call them — and then, from one Field state,
     2 steps of it and 2 of `step_native` on the same tensors: bit-equal for
     the smoke and the 2D models, within 1e-5 of each array's max for FLIP
     (K8's atomics), the CG counts equal (FLIP: at most 1 apart), the same
     launches a step of every kernel (`field vs native` lines); the fused
     and the FLIP 128³ path also print both steps' host-clock ms/step,
     alternating in 3 rounds of 3 steps. Three of
     SmokePlume(cg_tol=1e-3, max_iterations=100): ms per step, Mcells/s, the
     advection / pressure split, CG iterations, max |div|, the displacement
     bound and finiteness:
     4a. the fused path, `step` at 256³ (K1–K5, K5 through the Field
         `_fused_advect`): K5 exactly 3 launches a step, K2 exactly 2 per
         smoothed level per V-cycle (4b too);
     4b. the per-phase path at 256³ through the Field phases `advect_smoke`,
         `advect_velocity`, `project` (K6 exactly 5 launches a step, and K1–K4);
     4c. the per-phase path in 2D at 4096² (K7; the 2D projection is PyTorch
         operations);
     4-field. the same Field phases from 4b's final state (K6 exactly 5
         launches a step, K1–K4 as many per V-cycle as on 4b); then 2 steps
         of them and of the `_native` phases from one state, velocity, smoke
         and pressure within 1e-5 of each field's max |·| with equal CG
         counts, and both paths' host-clock ms/step, alternating in 3 rounds
         of 3 steps;
     and two of FlipLiquid(dims=3, points_per_cell=8), the Field `step`
     through K8 and its mean (`resample(particles, grid, scatter=True)`,
     exactly 4 launches a step each: the three face grids and the
     occupancy) and K1m (6 + 4 per CG iteration): ms per step, M particles/s, the split P2G + fill /
     projection / G2P + RK4 + push (the array layer's phases), CG iterations and `converged`, max
     |div·active|; the particle count kept, positions finite and inside the
     box ± 0.5, the mean height falling:
     4d. 128³, 1,061,208 particles;
     4e. 64³, 125,000 particles;
     and one of obstacles in the closed box, driven through the public
     functions (the JAX package has no 3D obstacle model; its entry point is
     `make_incompressible` itself):
     4f. obstacle-256: 256³ from a smooth divergent velocity with a stationary
         sphere, a translating cuboid and a translating, spinning sphere; a
         step moves the obstacles, advects the velocity with `mac_cormack`
         (K6, 6 launches) and projects with `make_incompressible(...,
         obstacles=...)` (K1m with its coefficient arrays and the accessible
         cells, exactly 6 + 4 per CG iteration; cg_tol 1e-4, at most 500
         iterations, not converging is reported, not an error): ms per step,
         Mcells/s, the split masks + boundary conditions / advection / solve /
         gradient, CG iterations and `converged`, the blocked cells, max
         |div·active − its mean| < 2e-4 (about ten times the 1.277e-05 read
         on an H100), 0 on the faces inside the stationary sphere and the cuboid's
         velocity on the faces inside it (1e-6);
     4g. obstacle-256-vcycle: the same step, 1 warm-up and 3 timed, with
         `fluid.MASKED_PRECONDITIONER = 'vcycle'` (the projected V-cycle: K1m
         exactly 1 + 1 per CG iteration, K2 exactly 12 and K3, K4 the same
         whole number of launches in each of the 1 + iterations V-cycles), the same gates with
         the divergence under 8e-4 (ten times its reading of 8.237e-05);
     4h. terrain-flip-128: a 3D version of examples/terrain_flip.py at 128³,
         1,310,720 particles of a liquid block over a heightmap terrain
         (`run_solid_flip` of `terrain_step`: P2G, finite_fill, the projection
         with the terrain as an obstacle and the occupied cells active, the
         FLIP update, finite_rk4, boundary_push out of the terrain): 20 steps
         for the block to fall onto the terrain, 2 warm-up and 5 timed steps,
         ms a step on the host clock and the device's busy time under
         torch.profiler, one more step with the terrain's queries (its masks,
         its push) timed inside it, K8 and K1m launched every step and no
         other kernel (every stencil launch the masked form), CG iterations >
         0, max |div| over the occupied cells the terrain does not cut, ≥ 97%
         of the particles at or above the terrain less one cell and > 1%
         within one cell of it, one step at 32³ from a state on the terrain
         (10 CPU steps), CPU against the card within FLIP's 5e-4 before and
         after the push, CG at most 1 apart; then each geometry at 10⁶ points
         against the CPU (`check_geometry_on_card`) and an obstacle of each
         new shape (the spline chute too, in float64 and float32) in a 16³
         projection, K1m launched, against the CPU (`check_obstacles_on_card`);
     then the two 2D obstacle models at the JAX benchmark's size,
     MovingObstacles(256) and LidDrivenCavity(256, obstacle=True), their
     Field `step`: ms per step, CG iterations, K7 launched (their masked
     stencil is PyTorch operations, as every 2D stencil; they are small for
     the card); then the 2D grid models, the last two of the JAX benchmark:
     K7 on Burgers' own first-step inputs (`halo='wrap'`, K = 2, the ±2 clamp
     reached) against its twin and timed there; Burgers(128, implicit=True)
     and Burgers(128), their Field `step` (ms per step, CG iterations a step,
     K7 exactly 2 launches a step and nothing else of ours, finite values);
     KolmogorovFlow(512, order=6, dt=0.002) in float32 (TF32 asserted off)
     and float64 (`set_global_precision(64)`), 1 warm-up step and 3 / 2 timed
     (ms per step, CG iterations a solve, max |divergence| of order 6, no
     kernel of ours launched, finite values); Burgers 128² (both diffusions,
     1e-3 abs) and Kolmogorov 64² order 6 (1e-4 of each field's scale, CG
     counts at most 1 apart, each step whose solves all converged) 2 steps
     from one numpy state on the CPU and on the card; then SPH, the dam
     break (`SphDamBreak`, its Field `step`; the cell list and the edge
     arithmetic are PyTorch operations, no kernel of ours may launch):
     sph-dam, the model's own configuration (10,000 particles, M = 189
     candidates a particle; 2 warm-up, 5 timed steps), and sph-dam-1.28M
     (nx=800, ny=1600, dx=0.0005, dt=1.25e-5: 1,280,000 particles, M = 153;
     1 + 3): ms per step, M particles/s, the particles dropped from the
     buckets at step 0 (3688 and 0) and the mean neighbours (19–21 at
     1.28 M) from the cell list run under `set_sync_debug_mode('error')`,
     the syncs a step (`'warn'`), `max_memory_allocated`, the state finite
     and inside [−0.02, 1.02]; then the cell list of the default's initial
     state bit-equal on the CPU and the card, its first step within 2e-6 in
     positions and 2e-4 in velocities (no later step: the model diverges
     from step 2), and nx=20 × 40 over 5 steps within 1e-6 and 2e-4; then
     FVM, the cylinder wake (`CylinderWake`, its Field `step`: the unstructured
     mesh's operators, BiCGStab and the mesh Chebyshev preconditioner are
     PyTorch operations, no kernel of ours may launch): cylinder-wake, the
     model's own configuration (400 × 128, 50,892 cells; 1 warm-up, 1 timed
     step), and cylinder-wake-1600x512 (nx=1600, ny=512, dt=0.0125: 814,160
     cells; 1 warm-up, 1 timed step: its pressure solves stop at 500
     iterations unconverged, and a third step would return the diverging
     BiCGStab's last iterate, as the JAX package's algorithm does at 800 ×
     256 in its first step): the mesh's build time on
     the host, ms per step, Mcells/s, each step's BiCGStab iterations and
     convergence, the syncs of the last warm-up step (`'warn'`),
     `max_memory_allocated`, max |v|, drag and lift, the state on the model's
     mesh, finite, max |v| < 3; then the default mesh's tables on the card
     bit-equal to the host's build, every operator of
     `field/_mesh_math.py` on random values within 1e-5 of its scale on the
     CPU and the card, and the JAX suite's wake (120 × 36, solve_tol 1e-5)
     over 3 steps on both (`FVM_CPU_CARD_TOL`); and
     K1m's, K6's and K8's launches a step × (device − bound) on each path
     that runs them (`gaps` lines);
  5. 2 steps from one numpy state on the CPU (the twins) and on the card (the
     kernels), compared at 1e-3 abs: fused at 64³, per-phase at 64³, 2D at
     256², FLIP at 32³ (positions); the obstacle step at 48³ under both
     preconditioners at 1e-4 abs with the CG counts at most 1 apart (these
     through `step_native`); the Field phases at 64³ and 256² at 1e-3; and on the card a Field-level
     `make_incompressible(v, [Obstacle(Sphere(...))])` at 48³ against the
     array-level call on the same tensors, 1e-4, CG counts at most 1 apart;
     then the gradients (`run_gradients`, phase 6) and the optimisation
     (`run_optimisation`, phase 7): `math.minimize` on the card —
     examples/piv.py's configuration (64², Box(x=20, y=20), 1024 markers,
     `advect.points` with `rk4`, dt 0.1; the coarse L-BFGS fit on
     `downsample(4)`, then the full one, 100 iterations each, abs_tol 1e-6;
     the velocity and markers from a numpy seed), gated on the example's
     assert (error < 0.5 × the field's) and on its first 3 L-BFGS
     iterations (the coarse fit's) card against CPU from one numpy state
     (1e-4 of scale; the full fit's first 3 printed beside, with each
     iteration's loss and step), with ms, loss evaluations and host syncs an iteration and
     `max_memory_allocated`; inverse-smoke-256: L-BFGS over the initial smoke
     of SmokePlume(256, dims=3), the target the smoke 2 Field steps from
     `smooth_state(256)`'s, 3 iterations, each printed with its launches (K6,
     K6ᵀ, K1–K4), forward and adjoint CG iterations, ms and memory, gated on
     the loss falling every iteration and those kernels launched (K5 not);
     examples/close_packing.py (64 spheres, 500 iterations), gated on its
     assert; and `grid_sample` (per-corner at 2^20 points, the slab route
     forced at 2^16 and at 2^20), `fft` → `ifft`, `convolve` (3³) and
     `histogram` (2^24 values) at 256³ card against CPU within 1e-5 (FFT
     1e-4) of scale; then the solvers and projections (`run_solvers`,
     phase 8): 8a methods-256, the 256³ closed box with `smooth_state`'s
     velocity projected from x0 = 0 at 1e-4 / 1e-4 (at most 500
     iterations) by 'CG', 'CG-adaptive' (the V-cycle, JAX's rule) and
     'biCG-stab', 'biCG-stab(2)' (unpreconditioned), 1 warm-up and 3 timed
     solves each: iterations, converged, ms, max |div|, K1 exactly its
     launches a solve and K2–K4 a V-cycle's, the CG family converged, every
     residual below ‖b‖ and finite; 8b obstacle-256-adaptive, 4f's step
     solved by 'CG-adaptive' (K1m 7 + 4 an iteration, the divergence under
     2e-4); 8c tunnel-512x256x256, Box(x=4, y=1, z=1) with flow through the x
     walls at unit speed around a sphere, projected through the Field API
     under 'auto' and 'CG-adaptive' (K1m exactly, finite, the divergence
     under TUNNEL_DIV_BOUND), then the open box (ZERO_GRADIENT: K1 with
     ghost0 sides and the V-cycle, exactly, converged); 8d
     examples/fluid_logo.py's 12 steps at 64² (its asserts as gates, its
     launches) and 2 steps card vs CPU at 1e-4 of scale; 8e the direct
     solve at 128² = 16384 unknowns in float64 against CG at 1e-10 (1e-6)
     with its ms, the reroute warning at 20000 unknowns, the Poiseuille
     march by 'biCG-stab(2)' in float64, `matrix_from_function` of the 64²
     periodic Laplacian and the nested domain, card vs CPU;
  9. batched simulation (`check_batched_kernels` with phase 3, `run_batched` after phase 8):
     9a K1 (each epilogue, with its dot), K2 (the zero-init pre-smooth f32 → bf16 and the post-smooth
     with its dot), K3 and K4 at B = 4 × 128³ and B = 3 × RAGGED, K1m there (coefficient arrays and
     active cells, each epilogue with its dot) with masks shared by the batch and with masks per
     entry, K6 at B = 4 × 128³ with a
     batched and a shared displacement (edge + extrema, const), K7 at B = 4 × 1024², K6ᵀ / K7ᵀ at the
     same shapes: each against its twin at phase 3's tolerances, entry by entry against the
     unbatched launch on that entry (outputs bit-equal, dots within 1e-6 relative; K6ᵀ / K7ᵀ's
     d_grid and d_disp bit-equal; a shared grid's d_grid bit-equal to the entries' own launches
     summed in order), exactly one launch a batched call;
     then (not with --quick) each batched form timed at B = 4 beside its unbatched launch on one
     entry (the row's `entry` part); 9b batched-smoke-256x4: SmokePlume(256, dims=3,
     batch_shape=batch(b=4)) from `smooth_state` seeds 0–3 through the Field `step` (per-phase):
     its first CG matvec (K1 with the per-entry dot) and K6 lookups (smoke and velocity components)
     against their twins on the inputs the step gave them, phase 3's tolerances; 2 warm-up and 5
     timed steps: ms/step, Mcells/s over all entries, CG iterations, launches a step (K6 exactly 5,
     K2 2 per smoothed level per V-cycle), `max_memory_allocated`, the busy share and device kernels
     a step under torch.profiler; then 2 steps batched against each entry's unbatched Field step
     (within 1e-5 of each array's max; the batched CG count the entries' largest; launches those of
     the unbatched path at the same CG counts); entry 0's unbatched step timed and profiled beside
     it; the same for batched-smoke-128x16 (B = 16 at 128³); 9c batched-smoke-2d:
     examples/batched_smoke.py's recipe at 64² with four inflow rates, 30 steps, card and CPU (K7
     exactly 4 a step; the example's monotone assert; 1e-3 of the smoke's max), and the CPU run with
     the rates one float32 ulp up against the CPU run (what rounding alone moves); 9d the batched 3D plume at 32³, b = 3, 2 steps, CPU vs card 1e-3;
     9e batched-grad-64 and batched-grad-256-2d: `math.gradient` of a batched rollout (b = 2),
     K6ᵀ / K7ᵀ once for each forward K6 / K7 launch, each entry within 1e-4 of its own gradient;
     9f batched-obstacle-256x4: 4f's obstacle step (its three moving obstacles shared by the batch,
     Chebyshev, cg_tol 1e-4) on four `smooth_state` velocities (seeds 0–3) at once, 1 warm-up and 2
     timed steps: ms/step, Mcells/s over all entries, CG iterations by entry, launches a step,
     `max_memory_allocated` above what was allocated before, one step under torch.profiler (device
     ms, kernels, busy share); gates: each entry bit-equal to its own unbatched obstacle steps, K1m
     (one launch for the batch) as often as the entry that iterates longest, max |div·active −
     mean| of each entry within OBSTACLE_DIV_BOUND, finite; then batched-obstacle-128x2-vcycle, the
     same at 2 × 128³ under the projected V-cycle;
  10. open and mixed boundaries (`run_open_boundaries`, after phase 9): 10a open-plume-256:
     SmokePlume(256, dims=3)'s inflow sphere, buoyancy, dt and cg_tol 1e-3 through the Field API
     with the velocity under combine_sides(x=0, y=0, z=(0, ZERO_GRADIENT)) (an open top), the smoke
     ZERO_GRADIENT and the pressure the derived extrapolation, from `smooth_state`; its last
     warm-up step records the inputs of its first CG matvec and window lookups, and K1 and K6 (its
     padded grids, mode None, and the smoke's edge halo) are held to their twins on them at phase
     3's tolerances; then 2 warm-up and 3 timed steps: ms/step, Mcells/s, CG iterations, launches a
     step (K6 exactly 5, K1 one a solve and one an iteration, K2 two per smoothed level a V-cycle,
     K3 / K4 a whole number a V-cycle, nothing else of ours), `max_memory_allocated`, finite, and
     the busy share and device kernels a step under torch.profiler; 10b tunnel-step-512x256x256:
     8c's Box(x=4, y=1, z=1) with no obstacle, the inflow vec(x=1, y=0, z=0) at x−, ZERO_GRADIENT at
     x+, walls at rest in y and z, smoke injected in the inflow's slab: the same readings and gates;
     then 2 steps of each (48³; 64 × 32 × 32) card against CPU at 1e-3 of each field's scale with
     the solves at 1e-5; 10c the 2D recipes: K7 against its twin on examples/wake_flow.py's first
     step, its 120 steps at 128 × 64 (its assert, wake deficit > 0.05, as a gate) and
     examples/variable_boundaries.py's 12 steps (its assert), K7 exactly 2 a step and nothing else
     of ours, then 2 steps of each card against CPU (1e-3 of each field's scale, the solves at
     1e-5); 10d the Field cases at 64³ and 256², card against CPU within 1e-4 of each result's
     scale (1e-3 for advection): SYMMETRIC, REFLECT, ANTISYMMETRIC, ANTIREFLECT and
     SYMMETRIC_GRADIENT in `laplace`, `resample`, the face gradient and `mac_cormack`; slicing a
     centred and a staggered grid; `stagger` at the centres and over (z, x); `resample(order=4)`;
     the gather (`max_cells=None`), `rk4` on a grid, `mac_cormack` of an open box's velocity, lookups
     at points of it; `substeps='auto'` at a CFL of 2.9 with max_cells=1 (3 substeps: the window
     kernel launched exactly 3 times, at most 2 device syncs a call, the lines printed); and
     `math.gradient` of one open-box 2D step (K7ᵀ once for each forward K7 launch, finite, card
     against CPU within 1e-4);
  11. the 3D mesh slice, I/O and utilities (`run_mesh_and_io`, after phase 10): 11a mesh-channel-3d,
     unit hexahedra over [0, 96] × [0, 32] × [0, 32] without the cube x ∈ [16, 24), y, z ∈ [12, 20)
     (97,792 cells; groups inlet, outlet, walls, cube), built by `geom.mesh` on the host, written
     as SU2 and read back by `load_su2` (its tables equal to the built ones), then CylinderWake's step
     in 3D (BiCGStab momentum on `_momentum_eq`, `make_incompressible` with 'auto'; velocity
     {inlet: (1, 0, 0), outlet: ZERO_GRADIENT, walls: (1, 0, 0), cube: 0}, ν = 8 / 150, dt 0.5,
     solve_tol 1e-4, 500 iterations at most, a transverse kick upstream of the cube), 1 warm-up and 2
     timed steps: the host build seconds, ms a step, BiCGStab iterations a solve, syncs of the warm-up
     step, `max_memory_allocated`, device busy ms and kernels a step (torch.profiler, one more step);
     gates: finite velocity and pressure, |div| after each projection below its value before, no
     kernel of ours launched; then 2 steps at 12 × 6 × 6 with a 2³ cube, CPU against card within 1e-4
     of scale with equal BiCGStab counts; 11b a 256³ smoke state from the card through `field.write`
     / `read`, a `Scene` and a checkpoint (`utils.save_checkpoint` / `load_checkpoint(device='cuda')`),
     each back on the card bit-equal; 11c the Field cases that raised before, card against CPU at 64³
     within 1e-5 (the divergence under ANTISYMMETRIC walls, a cloud of spheres resampled onto a grid
     without scatter, hard, soft and staggered, a grid Field and the cloud sampled at a mesh); 11d
     `_entry.entry()` on the card, 2 steps, finite, K6 and K1 launched;
  12. the splines and the user namespace (`run_splines`, after phase 11): spline-flip-128, FLIP's
     full width (128³ unit cells, Box['x,y,z', 16:64, 16:112, 80:116] at 8 particles a cell,
     1,327,104 particles) dropped onto a SplineSolid chute (a 5 × 3 net, thickness 8, fillets u 1 /
     v 0.5, order u 2 / v 1) whose signed distance shapes the projection's masks (K1m's mA / c0,
     with `active`) and the push: phase 4h's `run_solid_flip` with the chute in place of the
     heightmap and its signed distance as the gap (the spline queries' split of a step timed inside
     one more step); then 10 CPU steps at 32³ and one step on the CPU and the card from that state,
     held at FLIP's 5e-4 with the chute's float64 witness (`as_float64`), and with its float32
     queries where they are well-conditioned (`hold_float32`: the step's particles, the push, the
     masks); the chute and `to_spline(cylinder)` at 10⁶ points and `transform_with_spline` card vs
     CPU (float64: at most 0.1% of the points on another branch, the rest within 1e-4 of scale;
     float32 where well-conditioned); `_argmin_2d`'s first index on ties and NaN; `from
     phiflow_tpu_torch.flow import *`, `verify()`, `detect_backends()`, `troubleshoot()`;
  13. the `kernels` JSON line (every row above and the batched forms, `<kernel>_batched`, whose
     launches are counted on phase 9's paths — K1m's on batched-obstacle-256x4; `launches_by_path`
     has phase 10's, 11's and 12's paths too), then
     the last line {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Each phase prints its seconds on the host clock as it ends (`phase …: … s`, the larger ones their
parts too, `part of phase …`), and the line before the card's carries them all.
"""
import functools
import json
import re
import statistics
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
BC_SETS = [(('neumann', 'neumann'),) * 3,
           (('periodic', 'periodic'),) * 3,
           (('neumann', 'ghost0'), ('periodic', 'periodic'), ('ghost0', 'neumann'))]
PATH_BC = BC_SETS[0]
SMALL = (24, 40, 72)
SMALL_NARROW = (24, 40, 24)  # z < 64: K2's 16 × 16 tile, its z wrapping inside a ragged tile where periodic
RAGGED = (24, 40, 70)  # a fine z that is no whole number of 16-byte groups: K4's scalar path in both dtypes
# K6: rows of more than two warps' 128 outputs, so that some blocks lie inside the grid; 262 takes the scalar route
K6_RAGGED = (12, 24, 262)
K6_ROWS = (12, 24, 264)
PATH_N = 256
PATH_N_2D = 4096  # 16.8 M cells, the cell count of 256³
FLIP_N = (128, 64)  # 1,061,208 and 125,000 particles at 8 a cell
OBSTACLE_N = 256

KERNELS = {  # launch-counter name → (source, the Pallas kernel it replaces)
    'poisson_stencil': ('phiflow_tpu_torch/csrc/poisson.cu', 'phiflow_tpu/ops/poisson.py:284'),
    'jacobi_sweeps': ('phiflow_tpu_torch/csrc/poisson.cu', 'phiflow_tpu/ops/poisson.py:671'),
    'residual_restrict': ('phiflow_tpu_torch/csrc/poisson.cu', 'phiflow_tpu/ops/poisson.py:507'),
    'prolong_add': ('phiflow_tpu_torch/csrc/transfer.cu', 'phiflow_tpu/ops/transfer.py:101'),
    'fused_advect': ('phiflow_tpu_torch/csrc/advect3d.cu', 'phiflow_tpu/ops/advect3d.py:232'),
    'window_interp_3d': ('phiflow_tpu_torch/csrc/interp.cu', 'phiflow_tpu/ops/interp.py:111'),
    'window_interp_2d': ('phiflow_tpu_torch/csrc/interp.cu', 'phiflow_tpu/ops/interp.py:323'),
    # K1m: the launches of K1's C entry with coefficient arrays or active cells (also counted in poisson_stencil)
    'poisson_stencil_masked': ('phiflow_tpu_torch/csrc/poisson.cu', 'phiflow_tpu/ops/poisson.py:284'),
    'p2g': ('phiflow_tpu_torch/csrc/p2g.cu', 'phiflow_tpu/ops/p2g.py:142'),
    # K8's mean, the epilogue launch of the same source (the JAX package forms it beside its kernel)
    'p2g_mean': ('phiflow_tpu_torch/csrc/p2g.cu', 'phiflow_tpu/ops/p2g.py:142'),
    # K1m with the coefficient arrays mA, c0 of obstacles (also counted in the two above)
    'poisson_stencil_coeffs': ('phiflow_tpu_torch/csrc/poisson.cu', 'phiflow_tpu/ops/poisson.py:284'),
    # K6T / K7T: the backward of K6 / K7 (the JAX package differentiates its window sum with XLA's AD instead,
    # phiflow_tpu/math/_nd.py:584-622)
    'window_interp_3d_grad': ('phiflow_tpu_torch/csrc/interp.cu', 'phiflow_tpu/ops/interp.py:111'),
    'window_interp_2d_grad': ('phiflow_tpu_torch/csrc/interp.cu', 'phiflow_tpu/ops/interp.py:323'),
}
# the batched forms (phase 9): the same kernels over a leading batch axis, one launch a call
BATCHED_KERNELS = ('poisson_stencil', 'jacobi_sweeps', 'residual_restrict', 'prolong_add', 'window_interp_3d',
                   'window_interp_2d', 'window_interp_3d_grad', 'window_interp_2d_grad', 'poisson_stencil_masked')
ROWS = {**KERNELS, **{f'{k}_batched': KERNELS[k] for k in BATCHED_KERNELS}}  # the `kernels` line's rows
FUSED_KERNELS = ('poisson_stencil', 'jacobi_sweeps', 'residual_restrict', 'prolong_add', 'fused_advect')
PHASES_3D_KERNELS = ('poisson_stencil', 'jacobi_sweeps', 'residual_restrict', 'prolong_add', 'window_interp_3d')
PHASES_2D_KERNELS = ('window_interp_2d',)
P2G_LAUNCHES_PER_STEP = 4  # three face grids and the occupancy grid, each a scatter and a mean
P2G_SHUFFLE_SEED = 9
OBSTACLE_DT = 0.5
K6_LAUNCHES_PER_OBSTACLE_STEP = 6  # MacCormack: a forward and a backward lookup per velocity component
K6_LAUNCHES_PER_PHASE_STEP = 5  # the smoke's MacCormack pair, a semi-Lagrangian lookup per velocity component
# of those, the MacCormack forward lookups, which compute the extrema too (physics/advect.py::mac_cormack)
K6_EXTREMA_PER_STEP = {'per-phase': 1, f'obstacle-{OBSTACLE_N}': 3, f'obstacle-{OBSTACLE_N}-vcycle': 3}
FUSED_CALLS_PER_STEP = 3  # K5: the smoke's forward and backward passes, the velocity
# K2, one launch a smooth of up to 3 sweeps: a smoothed level's zero-init pre-smooth (ν = 3) and its post-smooth
K2_LAUNCHES_PER_LEVEL = 2


class Checks:
    """Kernel-versus-twin comparisons and timings, by row of the `kernels` line."""

    def __init__(self):
        self.max_err = {k: 0.0 for k in ROWS}
        self.passed = {k: 0 for k in ROWS}
        self.timing = {}
        self.failed = []

    def compare(self, kernel, case, got, ref, tol):
        """float32 results: max |got − ref| ≤ tol. bfloat16 results: within one
        bf16 ulp of ref plus tol — both sides round float32 arithmetic once,
        their sums run in different orders, and where a result cancels to near
        zero the float32 difference alone can exceed its bf16 ulp."""
        import torch
        g, r = got.float(), ref.float()
        diff = (g - r).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        if got.dtype == torch.bfloat16:
            _, e = torch.frexp(r.abs())
            ok = bool((diff <= torch.ldexp(torch.ones_like(r), e - 8) + tol).all())
            tol_s = f'ulp+{tol:.0e}'
        else:
            ok = err <= tol
            tol_s = f'{tol:.0e}'
        ok = ok and bool(torch.isfinite(g).all())
        self.max_err[kernel] = max(self.max_err[kernel], err)
        print(f'check {kernel:17s} {case:58s} max_abs_err={err:.3e} tol={tol_s:10s} {"ok" if ok else "FAIL"}')
        if not ok:
            self.failed.append(f'{kernel} {case}')
        self.passed[kernel] += ok

    def compare_with_nan(self, kernel, case, got, ref, tol):
        """`compare` for results in which NaN is data: the NaN patterns must
        be equal, the other entries within tol."""
        import torch
        same = bool((torch.isnan(got) == torch.isnan(ref)).all())
        if not same:
            print(f'check {kernel:17s} {case:58s} NaN patterns differ FAIL')
            self.failed.append(f'{kernel} {case} NaN pattern')
            return
        self.compare(kernel, case, torch.nan_to_num(got, nan=0.0), torch.nan_to_num(ref, nan=0.0), tol)

    def compare_nonfinite(self, kernel, case, got, ref, tol):
        """`compare` for results that hold NaN and +-inf: the patterns of NaN,
        +inf and -inf must be equal, the finite entries within tol."""
        import torch
        same = got.shape == ref.shape and all(bool((f(got) == f(ref)).all())
                                              for f in (torch.isnan, torch.isposinf, torch.isneginf))
        if not same:
            print(f'check {kernel:17s} {case:58s} NaN / inf patterns differ FAIL')
            self.failed.append(f'{kernel} {case} NaN / inf pattern')
            return
        fin = torch.isfinite(ref)
        self.compare(kernel, case, torch.where(fin, got, 0.0), torch.where(fin, ref, 0.0), tol)

    def compare_dot(self, kernel, case, got, ref, rtol):
        err = abs(float(got) - float(ref))
        ok = err <= rtol * max(abs(float(ref)), 1.0)
        print(f'check {kernel:17s} {case:58s} dot {float(got):.6e} vs {float(ref):.6e} '
              f'rel_err={err / max(abs(float(ref)), 1.0):.2e} tol={rtol:.0e} {"ok" if ok else "FAIL"}')
        if not ok:
            self.failed.append(f'{kernel} {case} dot')
        self.passed[kernel] += ok

    def time(self, kernel, what, fn_kernel, fn_plain, n_bytes, n_ops, fn_library=None, key=None, plain_reps=None):
        """Times are kept under `key` (default: the kernel's name, whose entry
        goes into the `kernels` line; any other key is printed only, or
        attached to its kernel's row by `attach`). Besides the eager `ms`, the
        wrapper's call (and the library's) is captured in a CUDA graph and
        replayed: `device_ms`, its time on the device without the host's
        share (Python, ctypes, allocation), which at small sizes is most of `ms`. `plain_reps`: the plain
        version timed that many times with no warm-up (a twin that takes seconds a call, called once before)."""
        ms = median_ms(fn_kernel)
        plain_ms = median_ms(fn_plain) if plain_reps is None else median_ms(fn_plain, reps=plain_reps, warmup=0)
        library_ms = median_ms(fn_library) if fn_library is not None else None
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / F32_OPS_PER_S * 1e3
        bound_ms, bound_by = (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')
        row = dict(timed=what, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                   device_ms=replay_ms(fn_kernel),
                   library_device_ms=replay_ms(fn_library) if fn_library is not None else None)
        lib = 'n/a' if library_ms is None else f'{library_ms:.4f}'
        lib_dev = 'n/a' if fn_library is None else f'{row["library_device_ms"]:.4f}'
        print(f'time  {kernel:17s} {what:58s} ms={ms:.4f} device_ms={row["device_ms"]:.4f} plain_ms={plain_ms:.4f} '
              f'library_ms={lib} library_device_ms={lib_dev} bound_ms={bound_ms:.4f} ({bound_by}; '
              f'{n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.2f} GFLOP) device/bound={row["device_ms"] / bound_ms:.2f}')
        self.timing[key or kernel] = row

    def side(self, kernel, what, fn, key):
        """A side reading kept under `key` (to be attached to `kernel`'s row): `ms` and `device_ms` of `fn` alone,
        a form the paths do not launch."""
        row = dict(timed=what, ms=median_ms(fn), device_ms=replay_ms(fn))
        print(f'time  {kernel:17s} {what:58s} ms={row["ms"]:.4f} device_ms={row["device_ms"]:.4f} (side reading)')
        self.timing[key] = row

    def attach(self, kernel, keys):
        """Put the rows timed under `keys` into `kernel`'s row as its `parts`."""
        self.timing[kernel].setdefault('parts', {}).update({k: self.timing.pop(k) for k in keys})


def median_ms(fn, reps=7, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def replay_ms(fn, reps=20):
    """Device time of one call of `fn`: its launches captured in a CUDA graph
    and replayed back to back, so the host's share of an eager call (Python,
    allocation, launch overhead) is left out. The arrays stay in the L2 cache
    between replays where they fit. The warm-up call runs on the capture
    stream, where it also makes the window kernels' flag of that stream
    (`_build.nonfinite_flag`) outside the graph."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# phase 3: kernels against their twins
# ---------------------------------------------------------------------------

def check_poisson(ch, gen, quick):
    import torch
    from phiflow_tpu_torch.ops import poisson as P
    dev = 'cuda'
    f32, bf16 = torch.float32, torch.bfloat16
    inv = (1.0, 0.7, 1.3)

    def rnd(shape, dtype=f32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # --- small shapes: every boundary set, epilogue and storage type; K1 and K3 at SMALL (their vector route),
    # SMALL_NARROW (rows narrower than a warp's runs: idle lanes) and RAGGED (their scalar route) ---
    for bcs in BC_SETS:
        tag = '/'.join(f'{lo[0]}{hi[0]}' for lo, hi in bcs)
        for shape in (SMALL, SMALL_NARROW, RAGGED):
            for dt, b_dt in ((f32, f32), (bf16, bf16), (bf16, f32), (f32, bf16)):
                p, b = rnd(shape, dt), rnd(shape, b_dt)
                for mode in ('matvec', 'residual', 'jacobi'):
                    if mode == 'matvec' and b_dt != dt:
                        continue  # b is not read
                    case = f'{mode} {shape} {tag} p {str(dt)[6:]}'
                    if mode != 'matvec':
                        case += f', b {str(b_dt)[6:]}'
                    ref, rdot = P._poisson_apply_plain(p, inv, bcs, b=b, mode=mode, omega_over_diag=0.15,
                                                       with_dot=True)
                    ch.compare('poisson_stencil', case, P.poisson_apply(p, inv, bcs, b=b, mode=mode,
                                                                        omega_over_diag=0.15), ref, 2e-5)
                    got, dot = P.poisson_apply(p, inv, bcs, b=b, mode=mode, omega_over_diag=0.15, with_dot=True)
                    ch.compare('poisson_stencil', case + ' with_dot', got, ref, 2e-5)
                    ch.compare_dot('poisson_stencil', case + ' with_dot', dot, rdot, 1e-5)
        w = 0.9 / (-2.0 * sum(inv))
        # K2: 1-3 sweeps in one launch (zero-init: u0 = w b is the first of them, alone at sweeps=1), u and b
        # stored in float32 or bfloat16, either result type, with and without the dot; and chains of launches:
        # 4 sweeps and the 24-sweep coarse smooth; in both tiles (16 × 64, and 16 × 16 where z < 64)
        for shape in (SMALL, SMALL_NARROW):
            for dt in (f32, bf16):
                u, b = rnd(shape, dt), rnd(shape, dt)
                for zero_init, sweeps in [(True, s) for s in (1, 2, 3, 4, 24)] + [(False, s) for s in (1, 2, 3)]:
                    for out_dtype in (f32, bf16):
                        args = (None if zero_init else u, b, inv, bcs, w, sweeps)
                        case = (f'{"zero-init" if zero_init else "warm"} sweeps={sweeps} {shape} {tag} '
                                f'{str(dt)[6:]}->{str(out_dtype)[6:]}')
                        ref, rdot = P._poisson_smooth_plain(*args, zero_init, out_dtype, True)
                        ch.compare('jacobi_sweeps', case,
                                   P.poisson_smooth(*args, zero_init=zero_init, out_dtype=out_dtype), ref, 2e-5)
                        got, dot = P.poisson_smooth(*args, zero_init=zero_init, out_dtype=out_dtype, emit_dot=True)
                        ch.compare('jacobi_sweeps', case + ' +dot', got, ref, 2e-5)
                        ch.compare_dot('jacobi_sweeps', case, dot, rdot, 1e-5)
        # K3 at the small shapes and at the fine shapes of the 48³ obstacle V-cycle's levels (fine z 12 and 6:
        # the scalar route in bfloat16, and in both dtypes)
        for shape in (SMALL, SMALL_NARROW, RAGGED) + tuple((n,) * 3 for n in (48, 24, 12, 6)):
            for dt in (f32, bf16):
                for b_dt in (f32, bf16):
                    u, b = rnd(shape, dt), rnd(shape, b_dt)
                    got = P.residual_restrict(u, b, inv, bcs)
                    ref = P._residual_restrict_plain(u, b, inv, bcs)
                    ch.compare('residual_restrict', f'{shape} {tag} u {str(dt)[6:]}, b {str(b_dt)[6:]}', got, ref,
                               1e-5)
    if quick:
        return
    # --- the 256³ path's shapes and dtypes (closed box = neumann everywhere) ---
    N3 = (PATH_N,) * 3
    one = (1.0, 1.0, 1.0)
    w = 0.9 / (-6.0)
    p = rnd(N3)
    got, dot = P.poisson_apply(p, one, PATH_BC, with_dot=True)
    ref, rdot = P._poisson_apply_plain(p, one, PATH_BC, with_dot=True)
    ch.compare('poisson_stencil', f'CG matvec {N3} float32', got, ref, 2e-5)
    ch.compare_dot('poisson_stencil', f'CG matvec {N3} float32', dot, rdot, 1e-5)
    weight = torch.zeros((1, 1, 3, 3, 3), device=dev)
    weight[0, 0, 1, 1, 1] = -6.0
    for c in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0), (1, 1, 2)):
        weight[(0, 0) + c] = 1.0
    F = torch.nn.functional
    ch.time('poisson_stencil', f'matvec + dot, {N3} float32', lambda: P.poisson_apply(p, one, PATH_BC, with_dot=True),
            lambda: P._poisson_apply_plain(p, one, PATH_BC, with_dot=True),
            nbytes(p, p), 22 * p.numel(),
            lambda: F.conv3d(F.pad(p[None, None], (1,) * 6, mode='replicate'), weight))
    b = rnd(N3)
    # a smoothed level array, as the V-cycle restricts it
    u = P._poisson_smooth_plain(P._poisson_smooth_plain(None, b, one, PATH_BC, w, 3, True, bf16, False), b, one,
                                PATH_BC, w, 3, False, bf16, False)
    got = P.residual_restrict(u, b, one, PATH_BC)
    ref = P._residual_restrict_plain(u, b, one, PATH_BC)
    ch.compare('residual_restrict', f'u bfloat16, b float32 {N3} -> bfloat16', got, ref, 1e-5)
    ch.time('residual_restrict', f'u bfloat16, b float32 {N3} -> bfloat16',
            lambda: P.residual_restrict(u, b, one, PATH_BC),
            lambda: P._residual_restrict_plain(u, b, one, PATH_BC),
            nbytes(u, b, got), 23 * u.numel())


V_CYCLES_PER_STEP = 4  # the fused 256³ path at 3 CG iterations: one V-cycle a solve and one an iteration
K1_LAUNCHES_PER_STEP = 4  # the CG matvec: A·x0 and one an iteration


def time_vcycle_levels(ch, gen):
    """K2, K3 and K4 checked against their twins and timed at every smoothed
    level of the 256³ V-cycle, in the dtypes `math/_multigrid.py` stores
    there: the float32 CG residual at the finest level, bfloat16 level arrays
    below it, the finest post-smooth to float32 with the dot. K2 within 2e-5
    (bfloat16: one ulp + 2e-5), its dot within 1e-5 relative; K3 within 1e-5;
    K4 bit-equal. The `jacobi_sweeps` row is the 256³ level's pre- and
    post-smooth together, against the bound of the two smooths (their inputs
    read once, their results written once). Each level's row is attached to
    its kernel's row as a part; the printed sums are launches × (device −
    bound) a V-cycle and a step, the number that ranks the kernels for a
    redesign."""
    import torch
    from phiflow_tpu_torch.ops import poisson as P, transfer as T
    f32, bf16 = torch.float32, torch.bfloat16
    keys = {'jacobi_sweeps': [], 'residual_restrict': [], 'prolong_add': []}

    def timed(kernel, what, fn, plain, n_bytes, n_ops, tol):
        """`fn` against `plain` (a result, or a (result, dot) pair) at `tol`, then both timed."""
        got, ref = fn(), plain()
        if isinstance(ref, tuple):
            ch.compare_dot(kernel, f'{what} (level)', got[1], ref[1], 1e-5)
            got, ref = got[0], ref[0]
        ch.compare(kernel, f'{what} (level)', got, ref, tol)
        del got, ref
        keys[kernel].append(f'{kernel} level {what}')
        ch.time(kernel, what, fn, plain, n_bytes, n_ops, key=keys[kernel][-1])

    n = PATH_N
    while n > 4 and smoothed_levels(n) > 0:
        finest = n == PATH_N
        inv = (1.0 / (PATH_N // n) ** 2,) * 3
        w = 0.9 / (-2.0 * sum(inv))
        cells = n ** 3
        b = torch.randn((n,) * 3, generator=gen, device='cuda').to(f32 if finest else bf16)
        post_dt = f32 if finest else bf16
        u = P._poisson_smooth_plain(None, b, inv, PATH_BC, w, 3, True, bf16, False)
        e = torch.randn((n // 2,) * 3, generator=gen, device='cuda').to(bf16)
        post = torch.empty(b.shape, dtype=post_dt, device='cuda')
        coarse = torch.empty(e.shape, dtype=bf16, device='cuda')
        tag = f'{n}^3'
        timed('jacobi_sweeps', f'{tag} pre-smooth zero-init x3, b {str(b.dtype)[6:]} -> bfloat16',
              lambda b=b, inv=inv, w=w: P.poisson_smooth(None, b, inv, PATH_BC, w, 3, zero_init=True, out_dtype=bf16),
              lambda b=b, inv=inv, w=w: P._poisson_smooth_plain(None, b, inv, PATH_BC, w, 3, True, bf16, False),
              nbytes(b, u), 2 * 23 * cells, 2e-5)
        timed('residual_restrict', f'{tag} u bfloat16, b {str(b.dtype)[6:]} -> {n // 2}^3 bfloat16',
              lambda u=u, b=b, inv=inv: P.residual_restrict(u, b, inv, PATH_BC),
              lambda u=u, b=b, inv=inv: P._residual_restrict_plain(u, b, inv, PATH_BC),
              nbytes(u, b, coarse), 23 * cells, 1e-5)
        timed('prolong_add', f'{tag} c {n // 2}^3 + u {tag} bfloat16',
              lambda e=e, u=u: T.prolong_add(e, u), lambda e=e, u=u: T._prolong_add_plain(e, u),
              nbytes(e, u, u), cells, 0.0)
        timed('jacobi_sweeps', f'{tag} post-smooth x3{" + dot" if finest else ""}, u bfloat16, '
                               f'b {str(b.dtype)[6:]} -> {str(post_dt)[6:]}',
              lambda u=u, b=b, inv=inv, w=w, dt=post_dt, dot=finest: P.poisson_smooth(
                  u, b, inv, PATH_BC, w, 3, out_dtype=dt, emit_dot=dot),
              lambda u=u, b=b, inv=inv, w=w, dt=post_dt, dot=finest: P._poisson_smooth_plain(
                  u, b, inv, PATH_BC, w, 3, False, dt, dot),
              nbytes(u, b, post), 3 * 23 * cells, 2e-5)
        if finest:
            ch.time('jacobi_sweeps', f'a {tag} level: pre-smooth zero-init x3 b float32 -> bfloat16, post-smooth x3 '
                                     f'+ dot u bfloat16 -> float32',
                    lambda: (P.poisson_smooth(None, b, inv, PATH_BC, w, 3, zero_init=True, out_dtype=bf16),
                             P.poisson_smooth(u, b, inv, PATH_BC, w, 3, out_dtype=f32, emit_dot=True)),
                    lambda: (P._poisson_smooth_plain(None, b, inv, PATH_BC, w, 3, True, bf16, False),
                             P._poisson_smooth_plain(u, b, inv, PATH_BC, w, 3, False, f32, True)),
                    nbytes(b, u) + nbytes(u, b, post), 5 * 23 * cells)
        n //= 2
    gaps = {}
    for kernel, ks in keys.items():
        gaps[kernel] = sum(ch.timing[k]['device_ms'] - ch.timing[k]['bound_ms'] for k in ks)
        ch.attach(kernel, ks)
    k1 = ch.timing['poisson_stencil']
    gaps_step = {k: V_CYCLES_PER_STEP * g for k, g in gaps.items()}
    gaps_step['poisson_stencil'] = K1_LAUNCHES_PER_STEP * (k1['device_ms'] - k1['bound_ms'])
    print('gaps  launches x (device - bound), summed over the 256^3 V-cycle levels: a V-cycle '
          + ', '.join(f'{k} {g:.4f} ms' for k, g in gaps.items())
          + f'; a fused step ({V_CYCLES_PER_STEP} V-cycles, {K1_LAUNCHES_PER_STEP} K1 launches) '
          + ', '.join(f'{k} {g:.4f} ms' for k, g in sorted(gaps_step.items(), key=lambda kv: -kv[1])))


def time_smooth_chunks(gen):
    """K2's device time at every smoothed level of the 256³ V-cycle (ν = 3,
    the dtypes of `time_vcycle_levels`) with each x-chunk of 1 to 64 planes a
    block fixed in `smooth_plan`, beside the chunk the plan picks: the
    measurement behind the plan's cost model."""
    import torch
    from phiflow_tpu_torch.ops import poisson as P
    f32, bf16 = torch.float32, torch.bfloat16
    n = PATH_N
    while n > 4 and smoothed_levels(n) > 0:
        finest = n == PATH_N
        inv = (1.0 / (PATH_N // n) ** 2,) * 3
        w = 0.9 / (-2.0 * sum(inv))
        b = torch.randn((n,) * 3, generator=gen, device='cuda').to(f32 if finest else bf16)
        u = P._poisson_smooth_plain(None, b, inv, PATH_BC, w, 3, True, bf16, False)
        post_dt = f32 if finest else bf16
        picked = [P.smooth_plan(b.shape, 3, zero, (None if zero else bf16, b.dtype, out))['chunk']
                  for zero, out in ((True, bf16), (False, post_dt))]
        rows = []
        for c in (1, 2, 4, 8, 16, 32, 64):
            if c > n:
                continue
            pre = replay_ms(lambda: P._smooth_cuda(None, b, inv, PATH_BC, w, 3, True, bf16, False, chunk=c))
            post = replay_ms(lambda: P._smooth_cuda(u, b, inv, PATH_BC, w, 3, False, post_dt, finest, chunk=c))
            rows.append(f'chunk {c}: pre {pre:.4f} post {post:.4f}')
        print(f'chunks {n}^3 (plan: pre chunk {picked[0]}, post chunk {picked[1]}) device ms: ' + '; '.join(rows),
              flush=True)
        n //= 2


def time_march_chunks(gen):
    """K1 (256³, float32, with the dot), K1m (its paths' forms: the obstacle
    masks at 256³, active cells at 128³; float32, with the dot) and K3 (every
    smoothed level of the 256³ V-cycle, in the dtypes of
    `time_vcycle_levels`) on the device with each x-chunk of 1 to 64 planes a
    block (K3: coarse planes) fixed in their plans, beside the chunk each
    plan picks: the measurement behind the plans' cost model."""
    import torch
    from phiflow_tpu_torch.ops import poisson as P
    f32, bf16 = torch.float32, torch.bfloat16
    one = (1.0, 1.0, 1.0)

    def sweep(what, planes, picked, fn):
        rows = [f'chunk {c}: {replay_ms(lambda c=c: fn(c)):.4f}' for c in (1, 2, 4, 8, 16, 32, 64) if c <= planes]
        print(f'chunks {what} (plan: chunk {picked}) device ms: ' + '; '.join(rows), flush=True)

    p = torch.randn((PATH_N,) * 3, generator=gen, device='cuda')
    sweep(f'K1 {PATH_N}^3 matvec + dot float32', PATH_N, P.stencil_plan(p.shape, f32)['chunk'],
          lambda c: P._stencil_cuda(p, one, PATH_BC, None, None, None, None, 'matvec', None, True, chunk=c))
    # K1m at its two paths' shapes and forms: the obstacle masks at 256³, the active cells at 128³
    mA, c0, accessible = obstacle_masks(OBSTACLE_N)
    sweep(f'K1m {OBSTACLE_N}^3 mA+c0+active matvec + dot float32, obstacle masks', OBSTACLE_N,
          P.stencil_plan(p.shape, f32, form='coeffs')['chunk'],
          lambda c: P._stencil_cuda(p, one, PATH_BC, mA, c0, accessible, None, 'matvec', None, True, chunk=c))
    del p, mA, c0, accessible
    p = torch.randn((FLIP_N[0],) * 3, generator=gen, device='cuda')
    active = (torch.rand(p.shape, generator=gen, device='cuda') < 0.7).float()
    sweep(f'K1m {FLIP_N[0]}^3 active matvec + dot float32', FLIP_N[0],
          P.stencil_plan(p.shape, f32, form='active')['chunk'],
          lambda c: P._stencil_cuda(p, one, PATH_BC, None, None, active, None, 'matvec', None, True, chunk=c))
    del p, active
    n = PATH_N
    while n > 4 and smoothed_levels(n) > 0:
        inv = (1.0 / (PATH_N // n) ** 2,) * 3
        b = torch.randn((n,) * 3, generator=gen, device='cuda').to(f32 if n == PATH_N else bf16)
        u = torch.randn((n,) * 3, generator=gen, device='cuda').to(bf16)
        sweep(f'K3 {n}^3 u bfloat16, b {str(b.dtype)[6:]}', n // 2, P.restrict_plan(u.shape, bf16, b.dtype)['chunk'],
              lambda c, u=u, b=b, inv=inv: P._residual_restrict_cuda(u, b, inv, PATH_BC, chunk=c))
        n //= 2


def _random_face_masks(shape, bcs, gen, dev):
    """0/1 masks of every face along each axis: N+1 entries along the own
    axis, N where it is periodic (face N is face 0); about one face in five
    closed, first and last planes included."""
    import torch
    masks = []
    for d, (lo, _) in enumerate(bcs):
        fshape = list(shape)
        fshape[d] += 0 if lo == 'periodic' else 1
        masks.append((torch.rand(fshape, generator=gen, device=dev) < 0.8).float())
    return masks


def check_poisson_masked(ch, gen, quick):
    """K1m against the twin: coefficient arrays from `stage_masks` of random
    face masks, active cells, and both, over boundary sets × epilogues × p
    and b in either dtype, with and without the dot, at SMALL (the vector
    route), SMALL_NARROW (idle lanes) and RAGGED (the scalar route)."""
    import torch
    from phiflow_tpu_torch.ops import poisson as P
    dev = 'cuda'
    f32, bf16 = torch.float32, torch.bfloat16
    inv = (1.0, 0.7, 1.3)

    def row(form):  # the kernel row a form's checks count for
        return 'poisson_stencil_masked' if form == 'active' else 'poisson_stencil_coeffs'

    def forms(shape, bcs, inv_dx2):
        mA, c0 = P.stage_masks(_random_face_masks(shape, bcs, gen, dev), bcs, inv_dx2)
        active = (torch.rand(shape, generator=gen, device=dev) < 0.7).float()
        return {'mA+c0': dict(mA_list=mA, c0=c0), 'active': dict(active=active),
                'mA+c0+active': dict(mA_list=mA, c0=c0, active=active)}

    for bcs in BC_SETS:
        tag = '/'.join(f'{lo[0]}{hi[0]}' for lo, hi in bcs)
        for shape in (SMALL, SMALL_NARROW, RAGGED):
            for form, kw in forms(shape, bcs, inv).items():
                name = row(form)
                for dt, b_dt in ((f32, f32), (bf16, bf16), (bf16, f32), (f32, bf16)):
                    p = torch.randn(shape, generator=gen, device=dev).to(dt)
                    b = torch.randn(shape, generator=gen, device=dev).to(b_dt)
                    for mode in ('matvec', 'residual', 'jacobi'):
                        if mode == 'matvec' and b_dt != dt:
                            continue  # b is not read
                        case = f'{form} {mode} {shape} {tag} p {str(dt)[6:]}'
                        if mode != 'matvec':
                            case += f', b {str(b_dt)[6:]}'
                        args = dict(b=b, mode=mode, omega_over_diag=0.15, **kw)
                        ref, rdot = P._poisson_apply_plain(p, inv, bcs, with_dot=True, **args)
                        ch.compare(name, case, P.poisson_apply(p, inv, bcs, **args), ref, 2e-5)
                        got, dot = P.poisson_apply(p, inv, bcs, with_dot=True, **args)
                        ch.compare(name, case + ' with_dot', got, ref, 2e-5)
                        ch.compare_dot(name, case + ' with_dot', dot, rdot, 1e-5)
    if quick:
        return
    # --- the FLIP path's shape: 128³, closed box, unit cells ---
    N3 = (FLIP_N[0],) * 3
    one = (1.0, 1.0, 1.0)
    p = torch.randn(N3, generator=gen, device=dev)
    b = torch.randn(N3, generator=gen, device=dev)
    all_forms = forms(N3, PATH_BC, one)
    for form, kw in all_forms.items():
        name = row(form)
        for mode in ('matvec', 'residual', 'jacobi'):
            got = P.poisson_apply(p, one, PATH_BC, b=b, mode=mode, omega_over_diag=-0.15, **kw)
            ref = P._poisson_apply_plain(p, one, PATH_BC, b=b, mode=mode, omega_over_diag=-0.15, **kw)
            ch.compare(name, f'{form} {mode} {N3}', got, ref, 2e-5)
        got, dot = P.poisson_apply(p, one, PATH_BC, with_dot=True, **kw)
        ref, rdot = P._poisson_apply_plain(p, one, PATH_BC, with_dot=True, **kw)
        ch.compare_dot(name, f'{form} matvec with_dot {N3}', dot, rdot, 1e-5)
        arrays = [p, got] + [m for v in kw.values() for m in (v if isinstance(v, list) else [v])]
        # the FLIP path's form (the free surface's active cells) is its row of the `kernels` line, the others are
        # parts of the coefficient row
        ch.time(name, f'{form}: matvec + dot, {N3} float32',
                lambda kw=kw: P.poisson_apply(p, one, PATH_BC, with_dot=True, **kw),
                lambda kw=kw: P._poisson_apply_plain(p, one, PATH_BC, with_dot=True, **kw),
                nbytes(*arrays), 22 * p.numel(), key=name if form == 'active' else f'{name} {form}')
    del p, b, all_forms
    masked_parts = [f'poisson_stencil_coeffs {form}' for form in ('mA+c0', 'mA+c0+active')]
    # --- the obstacle path's shape and its own masks: 256³, the three obstacles' open faces and accessible cells ---
    N3 = (OBSTACLE_N,) * 3
    mA, c0, accessible = obstacle_masks(OBSTACLE_N)
    kw = dict(mA_list=mA, c0=c0, active=accessible)
    p = torch.randn(N3, generator=gen, device=dev)
    got, dot = P.poisson_apply(p, one, PATH_BC, with_dot=True, **kw)
    ref, rdot = P._poisson_apply_plain(p, one, PATH_BC, with_dot=True, **kw)
    name = 'poisson_stencil_coeffs'
    ch.compare(name, f'mA+c0+active matvec, obstacle masks {N3}', got, ref, 2e-5)
    ch.compare_dot(name, f'mA+c0+active matvec with_dot, obstacle masks {N3}', dot, rdot, 1e-5)
    del ref
    # 7 arrays read or written once; this row goes into the `kernels` line
    ch.time(name, f'mA+c0+active: matvec + dot, obstacle masks, {N3} float32',
            lambda: P.poisson_apply(p, one, PATH_BC, with_dot=True, **kw),
            lambda: P._poisson_apply_plain(p, one, PATH_BC, with_dot=True, **kw),
            nbytes(p, got, *mA, c0, accessible), 22 * p.numel())
    ch.attach(name, masked_parts)
    del p, got, mA, c0, accessible, kw
    torch.cuda.empty_cache()


def _particles(n_cells, points_per_cell, gen, dev, lower, dx, stray=0.02):
    """Random particle positions (N, 3) over a grid of `n_cells` cells of size
    dx from `lower`: uniform inside, a share `stray` up to two cells outside on
    any side, and one particle in 64 exactly on a cell border; with values."""
    import torch
    n = n_cells[0] * n_cells[1] * n_cells[2] * points_per_cell
    res = torch.tensor(n_cells, device=dev, dtype=torch.float32)
    u = torch.rand((n, 3), generator=gen, device=dev)
    cells = u * res
    outside = torch.rand((n, 1), generator=gen, device=dev) < stray
    cells = torch.where(outside, u * (res + 4.0) - 2.0, cells)
    on_border = torch.rand((n, 3), generator=gen, device=dev) < 1.0 / 64
    cells = torch.where(on_border, torch.round(cells), cells)
    pos = cells * torch.tensor(dx, device=dev) + torch.tensor(lower, device=dev)
    return pos.contiguous(), torch.randn(n, generator=gen, device=dev)


def _flip_particles(N, gen, dev, stretch=False):
    """FLIP's particles at N³ in the path's order (`distribute_points`: cell by
    cell, 8 a cell), as the path's first step scatters them, or with `stretch`
    the block moved to the corner and stretched past two walls so that some
    lie outside every face grid; and random values."""
    import torch
    from phiflow_tpu_torch.models import FlipLiquid
    pos = torch.from_numpy(FlipLiquid(N, dims=3, points_per_cell=8, device='cuda').positions0).to(dev)
    if stretch:
        pos = ((pos - 0.15 * N) * 1.2 - 1.0).contiguous()
    return pos, torch.randn(pos.shape[0], generator=gen, device=dev)


def _shuffled(pos, vals, seed=P2G_SHUFFLE_SEED):
    """The same particles in a random order: one permutation of positions and
    values from a generator seeded here. No warp then shares a cell often."""
    import torch
    shuffle = torch.Generator(device=pos.device)
    shuffle.manual_seed(seed)
    perm = torch.randperm(pos.shape[0], generator=shuffle, device=pos.device)
    return pos[perm].contiguous(), vals[perm].contiguous()


def _flip_grid(N, axis):
    """(res, lower) of the FLIP grid at N³ that `axis` names: a face grid, or
    the cells (None), as `scatter_to_grid` builds them."""
    from phiflow_tpu_torch.field._resample import face_grid
    res, lo, _ = face_grid((N,) * 3, (1.0,) * 3, axis)
    return res, tuple(float(x) for x in lo)


def check_p2g(ch, gen, quick):
    """K8 against its twin: counts exactly; sums to float32 roundoff of a
    cell's addends (1e-6 of the largest sum: the atomics add in any order), or
    exactly where the values are integers; the mean of the same call bit-equal
    to the twin's formula on its own sums and counts; the mean against the
    twin's with the same NaN pattern. Cases: (a) FLIP's particles in the path's
    order onto its four grids; (b) the same shuffled; (c) every particle in
    one cell, integer values; (d) NaN and infinite values on dropped particles
    in the warps of finite ones, and NaN values of kept particles; (e) particle
    counts that are no multiple of a warp or a block."""
    import torch
    from phiflow_tpu_torch.ops import p2g as G
    dev = 'cuda'

    def check(case, pos, vals, res, lower, inv_dx, clamp, base, exact=False):
        sums, counts = G.p2g_sums_counts(pos, vals, res, lower, inv_dx, clamp)
        rsums, rcounts = G._p2g_plain(pos, vals, res, lower, inv_dx, clamp)
        case = f'{case} {"clamp" if clamp else "discard"}'
        ch.compare('p2g', f'{case} counts (exact)', counts, rcounts, 0.0)
        tol = 0.0 if exact else 1e-6 * max(1.0, float(torch.nan_to_num(rsums, nan=0.0).abs().max()))
        ch.compare_with_nan('p2g', f'{case} sums{" (exact)" if exact else ""}', sums, rsums, tol)
        mean, msums, mcounts = G._p2g_cuda(pos, vals, res, lower, inv_dx, clamp, base)
        ch.compare('p2g', f'{case} counts of the mean call (exact)', mcounts, rcounts, 0.0)
        ch.compare_with_nan('p2g_mean', f'{case} mean = its sums / counts, base {base} (bit-equal)', mean,
                            G._mean_or_base(msums, mcounts, base), 0.0)
        got = G.p2g_mean_3d(pos, vals, res, lower, inv_dx, clamp, base)
        ch.compare_with_nan('p2g_mean', f'{case} mean, base {base}', got, G._mean_or_base(rsums, rcounts, base), 5e-6)

    # --- a small grid that is not cubic, cells of 0.5 × 1.0 × 0.25 from a lower corner off the origin ---
    lower, dx = (0.5, -1.0, 0.25), (0.5, 1.0, 0.25)
    inv = tuple(1.0 / h for h in dx)
    pos, vals = _particles(SMALL, 2, gen, dev, lower, dx)
    for clamp in (False, True):
        for base in (0.0, float('nan')):
            check(f'{pos.shape[0]} particles -> {SMALL}', pos, vals, SMALL, lower, inv, clamp, base)
    # (e) a count that is no multiple of 32 or of the block's 256; then also an odd number of cells (the mean's
    # scalar route: the counts plane is not 16-byte aligned)
    for clamp in (False, True):
        check(f'(e) {pos.shape[0] - 77} particles -> {SMALL}', pos[:-77], vals[:-77], SMALL, lower, inv, clamp,
              float('nan'))
    odd = (7, 13, 21)
    odd_pos, odd_vals = _particles(odd, 3, gen, dev, lower, dx)
    for clamp, base in ((False, 0.0), (True, float('nan'))):
        check(f'(e) {odd_pos.shape[0]} particles -> {odd}', odd_pos, odd_vals, odd, lower, inv, clamp, base)
    # (d) dropped particles valued NaN, +inf, -inf beside finite ones; kept particles valued NaN (1 in 997)
    _, outside = G._cell_ids(pos, SMALL, lower, inv, False)
    outside = ~outside
    poison = torch.tensor([float('nan'), float('inf'), float('-inf')], device=dev)[
        torch.arange(pos.shape[0], device=dev) % 3]
    check(f'(d) {int(outside.sum())} of {pos.shape[0]} dropped valued NaN/inf -> {SMALL}', pos,
          torch.where(outside, poison, vals), SMALL, lower, inv, False, 0.0)
    kept_nan = torch.where(torch.arange(pos.shape[0], device=dev) % 997 == 5, float('nan'), vals)
    for clamp in (False, True):
        check(f'(d) kept particles valued NaN -> {SMALL}', pos, kept_nan, SMALL, lower, inv, clamp, float('nan'))
    # (c) every particle in cell (3, 5, 7), integer values: the sums are exact in any order of addition
    n_one = 100_003
    cell = torch.tensor([3.0, 5.0, 7.0], device=dev)
    one_pos = ((cell + torch.rand((n_one, 3), generator=gen, device=dev) * 0.98 + 0.01)
               * torch.tensor(dx, device=dev) + torch.tensor(lower, device=dev)).contiguous()
    ints = torch.randint(-8, 9, (n_one,), generator=gen, device=dev).float()
    for clamp in (False, True):
        check(f'(c) {n_one} particles in one cell, integer values -> {SMALL}', one_pos, ints, SMALL, lower, inv,
              clamp, 0.0, exact=True)
    if quick:
        return
    # (a) the FLIP paths' particle sets in the path's order, as timed and stretched past the walls, and (b) the
    # same shuffled, onto the four target grids
    for N in FLIP_N:
        orders = []
        for stretch in (False, True):
            pos, vals = _flip_particles(N, gen, dev, stretch)
            tag = ' stretched' if stretch else ''
            orders += [(f'(a){tag}', pos, vals), (f'(b){tag} shuffled', *_shuffled(pos, vals))]
        for order, p, v in orders:
            for axis in (None, 0, 1, 2):
                res, lo = _flip_grid(N, axis)
                clamp, base = (False, 0.0) if axis is None else (True, float('nan'))
                check(f'{order} {p.shape[0]} particles -> {res}', p, v, res, lo, (1.0,) * 3, clamp, base)


def p2g_row(kind, N, order, grid):
    """The key of a timed K8 row: `kind` (`p2g`, sums + counts; `p2g_mean`,
    the whole mean) itself for the kernels line's row (128³, path order, x
    faces), else a part of it."""
    if (N, order, grid) == (FLIP_N[0], 'path order', 'x faces'):
        return kind
    return f'{kind} {N}^3 {order}, {grid}'


def p2g_timing(ch, kind, N, order, grid):
    key = p2g_row(kind, N, order, grid)
    return ch.timing[kind] if key == kind else ch.timing[kind]['parts'][key]


def time_p2g(ch, gen):
    """K8's rows at the FLIP paths' shapes, on the particles of the path's
    first step: sums + counts (`p2g`, beside the two `index_add_` that compute
    them from precomputed cell ids) and the whole mean as the path calls it
    (`p2g_mean`, beside one `index_reduce_` mean from the same ids), onto the
    x faces (clamp, base NaN) and the cells (discard, base 0), in the path's
    order at 128³ and 64³ and shuffled at 128³. Per particle 12 B of position
    and 4 B of value are read; per cell 8 B written for sums + counts, 4 B for
    the mean (the function's output; the call also writes the counts, the
    backward's residual, which the bound leaves out)."""
    import torch
    from phiflow_tpu_torch.ops import p2g as G
    dev = 'cuda'
    one = (1.0,) * 3
    nan = float('nan')
    keys = {'p2g': [], 'p2g_mean': []}
    for N in FLIP_N:
        pos, vals = _flip_particles(N, gen, dev)
        orders = [('path order', pos, vals)] + ([('shuffled', *_shuffled(pos, vals))] if N == FLIP_N[0] else [])
        for order, p, v in orders:
            for grid, axis, clamp, base in (('x faces', 0, True, nan), ('cells', None, False, 0.0)):
                res, lo = _flip_grid(N, axis)
                n_cells = res[0] * res[1] * res[2]
                ids, valid = G._cell_ids(p, res, lo, one, clamp)
                w, ones = torch.where(valid, v, 0.0), valid.float()

                kept_ids, kept_v = ids[valid], v[valid]

                def library(ids=ids, w=w, ones=ones, n_cells=n_cells):
                    out = torch.zeros((2, n_cells), device=dev)
                    out[0].index_add_(0, ids, w)
                    out[1].index_add_(0, ids, ones)
                    return out

                def library_mean(ids=kept_ids, v=kept_v, n_cells=n_cells, base=base):
                    return torch.full((n_cells,), base, device=dev).index_reduce_(0, ids, v, 'mean',
                                                                                  include_self=False)

                what = f'{p.shape[0]} particles ({order}) -> {grid} {res}, {"clamp" if clamp else "discard"}'
                n_bytes, n_ops = 16 * p.shape[0] + 8 * n_cells, 8 * p.shape[0]
                key = p2g_row('p2g', N, order, grid)
                ch.time('p2g', f'sums + counts of {what}',
                        lambda p=p, v=v, res=res, lo=lo, clamp=clamp: G.p2g_sums_counts(p, v, res, lo, one, clamp),
                        lambda p=p, v=v, res=res, lo=lo, clamp=clamp: G._p2g_plain(p, v, res, lo, one, clamp),
                        n_bytes, n_ops, library, key=key)
                keys['p2g'].append(key)
                key = p2g_row('p2g_mean', N, order, grid)
                twin_mean = G._mean_or_base(*G._p2g_plain(p, v, res, lo, one, clamp), base)
                ch.compare_with_nan('p2g_mean', f'library index_reduce_ mean of {what}', library_mean().reshape(res),
                                    twin_mean, 5e-6)
                ch.time('p2g_mean', f'mean of {what}, base {base}',
                        lambda p=p, v=v, res=res, lo=lo, clamp=clamp, base=base:
                            G.p2g_mean_3d(p, v, res, lo, one, clamp, base),
                        lambda p=p, v=v, res=res, lo=lo, clamp=clamp, base=base:
                            G._mean_or_base(*G._p2g_plain(p, v, res, lo, one, clamp), base),
                        16 * p.shape[0] + 4 * n_cells, n_ops + 2 * n_cells, library_mean, key=key)
                keys['p2g_mean'].append(key)
    for kind, ks in keys.items():
        ch.attach(kind, [k for k in ks if k != kind])
    # the share of the memset in each call: zeroing the same bytes (a PyTorch fill) at 128³ x faces
    res, _ = _flip_grid(FLIP_N[0], 0)
    planes = torch.empty((2,) + res, device=dev)
    zeroing = dict(timed=f'zeroing sums + counts of x faces {res} (a PyTorch fill)', device_ms=replay_ms(planes.zero_),
                   bound_ms=nbytes(planes) / HBM_BYTES_PER_S * 1e3)
    print(f'time  p2g               {zeroing["timed"]:58s} device_ms={zeroing["device_ms"]:.4f} '
          f'bound_ms={zeroing["bound_ms"]:.4f} (bytes; {nbytes(planes) / 1e6:.1f} MB)')
    ch.timing['p2g']['zeroing'] = zeroing


def check_transfer(ch, gen, quick):
    import torch
    from phiflow_tpu_torch.ops import transfer as T
    dev = 'cuda'
    # SMALL's rows are whole 16-byte groups (the vector path), RAGGED's are not (the masked scalar path)
    for fine in (SMALL, RAGGED):
        coarse = tuple(n // 2 for n in fine)
        for dt in (torch.float32, torch.bfloat16):
            c = torch.randn(coarse, generator=gen, device=dev).to(dt)
            u = torch.randn(fine, generator=gen, device=dev).to(dt)
            ch.compare('prolong_add', f'c {coarse} + u {fine} {str(dt)[6:]}',
                       T.prolong_add(c, u), T._prolong_add_plain(c, u), 0.0)
            ch.compare('prolong_add', f'upsample c {coarse} {str(dt)[6:]}',
                       T.prolong_pc(c), T._prolong_add_plain(c, None), 0.0)
    if quick:
        return
    c = torch.randn((PATH_N // 2,) * 3, generator=gen, device=dev).to(torch.bfloat16)
    u = torch.randn((PATH_N,) * 3, generator=gen, device=dev).to(torch.bfloat16)
    got = T.prolong_add(c, u)
    ch.compare('prolong_add', f'c {tuple(c.shape)} + u {tuple(u.shape)} bfloat16', got,
                   T._prolong_add_plain(c, u), 0.0)
    ch.time('prolong_add', f'c {tuple(c.shape)} + u {tuple(u.shape)} bfloat16',
            lambda: T.prolong_add(c, u), lambda: T._prolong_add_plain(c, u),
            nbytes(c, u, got), u.numel(),
            lambda: torch.nn.functional.interpolate(c[None, None], scale_factor=2, mode='nearest'))
    # the float32 form at 128³ (a V-cycle of float32 levels, below 64³ or off CUDA's bfloat16 rule)
    c = torch.randn((PATH_N // 4,) * 3, generator=gen, device=dev)
    u = torch.randn((PATH_N // 2,) * 3, generator=gen, device=dev)
    got = T.prolong_add(c, u)
    what = f'c {tuple(c.shape)} + u {tuple(u.shape)} float32'
    ch.compare('prolong_add', what, got, T._prolong_add_plain(c, u), 0.0)
    ch.time('prolong_add', what, lambda: T.prolong_add(c, u), lambda: T._prolong_add_plain(c, u),
            nbytes(c, u, got), u.numel(),
            lambda: torch.nn.functional.interpolate(c[None, None], scale_factor=2, mode='nearest'),
            key='prolong_add float32')
    ch.attach('prolong_add', ['prolong_add float32'])


def _advect_inputs(N, gen, dev, K=1, periodic=False):
    """Random velocity (|v|·dt/dx up to 1.25·K cells: the ±K clip is reached)
    in the closed or the periodic layout, and smoke, for the fused calls."""
    import torch
    shapes = [[n - (0 if periodic else a == d) for a, n in enumerate(N)] for d in range(3)]
    vel = [((torch.rand(s, generator=gen, device=dev) * 5.0 - 2.5) * K).contiguous() for s in shapes]
    smoke = torch.rand(N, generator=gen, device=dev)
    return vel, smoke


def _advect_calls(N, K, vel_t, smoke, periodic):
    """The three fused calls of a step on these inputs (their extras from the
    twin), and a call of several outputs in every form at once."""
    import torch
    from phiflow_tpu_torch.ops.advect3d import OutSpec, Source, _fused_advect_plain
    scales = (-0.5,) * 3
    v_mode, s_mode = ('wrap', 'wrap') if periodic else ('const', 'edge')
    vel = [Source(vel_t[d], own_axis=d, mode=v_mode) for d in range(3)]
    ball = (N[0] / 2, N[1] / 2, N[2] / 8, N[0] / 10, 0.2)
    s1 = vel + [Source(smoke, mode=s_mode)]
    o1 = [OutSpec(slab=3, extrema=True)]
    [(fwd, lo, up)] = _fused_advect_plain(s1, N, K, o1, scales, [])
    s2 = vel + [Source(fwd, mode=s_mode)]
    o2 = [OutSpec(slab=3, negate=True, combine=(0, 1, 2, 1.0), add_ball=ball, emit_lift=(2, 0.05))]
    [(_, lift)] = _fused_advect_plain(s2, N, K, o2, scales, [smoke, lo, up])
    o3 = [OutSpec(slab=d, d_own=d) for d in range(3)]
    o3[2] = o3[2]._replace(add_blocked=(0, 1.0))
    # five sources, four outputs: a staggered output of an advected scalar, a centred one of a velocity component
    mixed = ([Source(smoke, mode=s_mode), Source(fwd, mode='const', const=0.25)],
             [OutSpec(slab=4, d_own=1, negate=True, extrema=True), OutSpec(slab=0, extrema=True, add_ball=ball),
              OutSpec(slab=2, d_own=2, emit_lift=(0, 0.5)), OutSpec(slab=3, d_own=0, add_blocked=(0, -2.0))])
    return scales, [('call 1: smoke forward + extrema', s1, o1, []),
                    ('call 2: backward + combine + ball + lift', s2, o2, [smoke, lo, up]),
                    ('call 3: velocity + buoyancy', vel, o3, [lift]),
                    ('five sources, four outputs', vel + mixed[0], mixed[1], [smoke])]


def _advect_nan_calls(N, K, vel_t, smoke, periodic, gen):
    """K5 at NaN velocities: NaN on a few faces of each velocity component, the advected arrays finite. A call 1
    (the smoke's forward pass with its extrema), a call 2 (the backward pass, combine, clip, ball and lift, its
    slab the finite forward values, lo / up ±3.4e38 where call 1 met a NaN) and the three staggered outputs of an
    advected scalar (the cross averages of the displacements). Returns (scales, calls) as `_advect_calls`."""
    import torch
    from phiflow_tpu_torch.ops.advect3d import OutSpec, Source, _fused_advect_plain
    vel_t = [v.clone() for v in vel_t]
    for v in vel_t:
        flat = v.view(-1)
        flat[torch.randint(0, flat.numel(), (max(1, flat.numel() // 2000),), generator=gen, device=v.device)] = \
            float('nan')
    scales, calls = _advect_calls(N, K, vel_t, smoke, periodic)
    (what1, s1, o1, _), (what2, s2, o2, x2) = calls[:2]
    v_mode = 'wrap' if periodic else 'const'
    vel = [Source(vel_t[d], own_axis=d, mode=v_mode) for d in range(3)]
    [(fwd, lo, up)] = _fused_advect_plain(s1, N, K, o1, scales, [])
    s2 = vel + [Source(torch.nan_to_num(fwd), mode=s2[3].mode)]
    staggered = [OutSpec(slab=3, d_own=d, extrema=True, negate=d == 1) for d in range(3)]
    return scales, [(what1, s1, o1, []), (what2, s2, o2, [smoke, lo, up]),
                    ('three staggered outputs of a scalar', s1, staggered, [])]


def check_advect(ch, gen, quick):
    """K5 against its twin: the three calls of a step and a call of four
    outputs, closed and periodic, K = 1, 2, 3; values within 2e-5, lo / up
    exactly. At NaN velocities (finite advected arrays) the same
    NaN pattern as the twin's, lo / up ±3.4e38 there. The step's three calls
    timed at 256³, K = 1."""
    import torch
    from phiflow_tpu_torch.ops.advect3d import fused_advect_3d, _fused_advect_plain
    dev = 'cuda'
    cases = [(SMALL, K, periodic) for K in (1, 2, 3) for periodic in (False, True)]
    if not quick:
        cases += [((PATH_N,) * 3, K, False) for K in (1, 2, 3)] + [((PATH_N,) * 3, 1, True)]
    for N, K, periodic in cases:
        vel_t, smoke = _advect_inputs(N, gen, dev, K, periodic)
        scales, calls = _advect_calls(N, K, vel_t, smoke, periodic)
        for what, srcs, outs, extras in calls:
            got = fused_advect_3d(srcs, N, K, outs, scales, extras)
            ref = _fused_advect_plain(srcs, N, K, outs, scales, extras)
            for i, (g, r) in enumerate(zip(got, ref)):
                g = g if isinstance(g, tuple) else (g,)
                r = r if isinstance(r, tuple) else (r,)
                for j, (gg, rr) in enumerate(zip(g, r)):
                    exact = outs[i].extrema and j in (1, 2)
                    ch.compare('fused_advect', f'{what} out{i}.{j}{" (exact)" if exact else ""} {N} K={K}'
                               f'{" periodic" if periodic else ""}', gg, rr, 0.0 if exact else 2e-5)
            del got, ref
        if N == SMALL:
            nan_scales, nan_calls = _advect_nan_calls(N, K, vel_t, smoke, periodic, gen)
            for what, srcs, outs, extras in nan_calls:
                got = fused_advect_3d(srcs, N, K, outs, nan_scales, extras)
                ref = _fused_advect_plain(srcs, N, K, outs, nan_scales, extras)
                for i, (g, r) in enumerate(zip(got, ref)):
                    g = g if isinstance(g, tuple) else (g,)
                    r = r if isinstance(r, tuple) else (r,)
                    for j, (gg, rr) in enumerate(zip(g, r)):
                        exact = outs[i].extrema and j in (1, 2)
                        ch.compare_with_nan('fused_advect', f'{what} out{i}.{j}{" (exact)" if exact else ""} {N} '
                                            f'K={K}{" periodic" if periodic else ""}, NaN velocities', gg, rr,
                                            0.0 if exact else 2e-5)
                del got, ref
        if N != SMALL and K == 1 and not periodic:
            # each input read once, each output written once: call 2's lift plane included
            (_, s1, o1, _), (_, s2, o2, x2), (_, s3, o3, x3) = calls[:3]
            fwd, lo, up = s2[3].values, x2[1], x2[2]
            moved = [nbytes(*vel_t, smoke) + 3 * nbytes(smoke),
                     nbytes(*vel_t, fwd, smoke, lo, up) + 2 * nbytes(smoke),
                     nbytes(*vel_t, x3[0]) + nbytes(*vel_t)]
            runs = [(lambda srcs=srcs, outs=outs, extras=extras: fused_advect_3d(srcs, N, K, outs, scales, extras),
                     lambda srcs=srcs, outs=outs, extras=extras: _fused_advect_plain(srcs, N, K, outs, scales, extras))
                    for _, srcs, outs, extras in calls[:3]]
            keys = []
            for i, ((what, _, outs, _), (fn, plain), n_bytes) in enumerate(zip(calls, runs, moved)):
                keys.append(f'fused_advect call {i + 1}')
                ch.time('fused_advect', f'{what} {N} K={K}', fn, plain, n_bytes, 60 * len(outs) * smoke.numel(),
                        key=keys[-1])
            ch.time('fused_advect', f'a step: calls 1-3 {N} K={K}', lambda: [fn() for fn, _ in runs],
                    lambda: [plain() for _, plain in runs], sum(moved), 60 * 5 * smoke.numel())
            ch.attach('fused_advect', keys)
        del vel_t, smoke, calls
        torch.cuda.empty_cache()


def _sample_coords(grid, disps, K, scale, pad=0):
    """The normalised sample coordinates (align_corners=True) of the window
    lookup for `F.grid_sample`: (N, *disps, d), the last axis first, N the
    entries of a leading batch axis of grid and displacements (1 without);
    `pad`: the cells `grid` is padded by on every side beyond the lattice."""
    import torch
    d = len(disps)
    coords = []
    for ax in range(d):
        n = grid.shape[grid.ndim - d + ax]
        idx = pad + torch.arange(disps[ax].shape[disps[ax].ndim - d + ax], device=grid.device,
                                 dtype=torch.float32).reshape((-1,) + (1,) * (d - ax - 1))
        pos = idx + torch.clamp(scale[ax] * disps[ax], -float(K), float(K))
        coords.append(pos * (2.0 / (n - 1)) - 1.0)
    coord_grid = torch.stack(coords[::-1], dim=-1)  # last entry first: (x, y[, z]) = (W, H[, D])
    return coord_grid if coord_grid.ndim == d + 2 else coord_grid[None]


def _grid_sample_lookup(grid, disps, K, scale, padding_mode, pad=0):
    """`torch.nn.functional.grid_sample` for the same lookup: a closure over
    the prebuilt normalised coordinate grid (align_corners=True), so that only
    the library call itself is timed. A leading batch axis (grid and
    displacements) is grid_sample's N; `pad` as in `_sample_coords`."""
    coord_grid = _sample_coords(grid, disps, K, scale, pad)
    d = len(disps)
    inp = grid.reshape((-1, 1) + tuple(grid.shape[grid.ndim - d:]))
    out = tuple(grid.shape[:grid.ndim - d]) + tuple(disps[0].shape[disps[0].ndim - d:])
    F = __import__('torch').nn.functional
    return lambda: F.grid_sample(inp, coord_grid, mode='bilinear', padding_mode=padding_mode,
                                 align_corners=True)[:, 0].reshape(out)


def _with_nan(disps, gen):
    """The displacements with NaN, where JAX's window sum gives NaN: a tenth of the outputs on the last
    axis alone, a twentieth on every axis. Returns (displacements, the outputs NaN on the last axis alone)."""
    import torch
    shape, dev = disps[0].shape, disps[0].device
    lone = torch.rand(shape, generator=gen, device=dev) < 0.1
    every = torch.rand(shape, generator=gen, device=dev) < 0.05
    holed = [torch.where(every | (lone if i == len(disps) - 1 else torch.zeros_like(lone)), float('nan'), x)
             for i, x in enumerate(disps)]
    return holed, lone & ~every


def check_interp(ch, gen, quick):
    """K6 / K7 against their twin: values within 1e-5, lo / up exactly; at NaN
    displacements (JAX's rule: a NaN value, lo / up ±3.4e38) the same NaN
    pattern as the twin's."""
    import torch
    from phiflow_tpu_torch.ops import interp as I
    dev = 'cuda'
    fns = {3: (I.window_interp_3d, 'window_interp_3d'), 2: (I.window_interp_2d, 'window_interp_2d')}

    def twin(grid, disps, K, extrema, negate, scale, mode, const=0.0):
        sgn = -1.0 if negate else 1.0
        return I._window_interp_plain(grid, list(disps), K, extrema, tuple(I._f32(sgn * x) for x in scale),
                                      mode, I._f32(const))

    def kernel(d, grid, disps, K, extrema, negate, scale, mode, const=0.0):
        halo = {None: {}, 'const': dict(const_pad=const), 'edge': dict(halo='edge'), 'wrap': dict(halo='wrap')}[mode]
        return fns[d][0](grid, disps, K, compute_extrema=extrema, negate=negate, disp_scale=scale, **halo)

    def compare(d, case, got, ref, extrema):
        name = fns[d][1]
        if not extrema:
            got, ref = (got,), (ref,)
        ch.compare(name, case + ' value', got[0], ref[0], 1e-5)
        for what, g, r in zip(('lo', 'up'), got[1:], ref[1:]):
            ch.compare(name, f'{case} {what} (exact)', g, r, 0.0)

    # --- small shapes: every halo, K, option; integer displacements. K7 also at rows of 45 and K6 at rows of
    #     262, which take the scalar loads and stores instead of float4; K6 also at rows of 264 (float4). The
    #     rows of 262 and 264 are long enough for blocks whose taps all lie inside the grid (direct addressing)
    #     beside the border blocks (the halo resolved), in the padded layout and the raw one ---
    for d, shape in ((3, SMALL), (3, K6_RAGGED), (3, K6_ROWS), (2, SMALL[1:]), (2, (37, 45))):
        scale = (0.8, -1.1, 0.6)[:d]
        for K in (1, 2):
            for mode in (None, 'const', 'edge', 'wrap'):
                gshape = tuple(n + 2 * K for n in shape) if mode is None else shape
                grid = torch.randn(gshape, generator=gen, device=dev)
                # up to ±(K + 1) cells after scaling: the clamp is reached
                disps = (torch.rand((d,) + shape, generator=gen, device=dev) * 2 - 1) * ((K + 1) / 0.6)
                for extrema, negate in ((False, False), (True, False), (True, True)):
                    case = (f'{shape} K={K} {mode or "padded"}{" extrema" if extrema else ""}'
                            f'{" negate" if negate else ""}')
                    got = kernel(d, grid, disps, K, extrema, negate, scale, mode, 0.25)
                    ref = twin(grid, disps, K, extrema, negate, scale, mode, 0.25)
                    compare(d, case, got, ref, extrema)
        K = 2
        grid = torch.randn(tuple(n + 2 * K for n in shape), generator=gen, device=dev)
        ints = torch.randint(-1, 2, (d,) + shape, generator=gen, device=dev).float() * K  # −K, 0, +K
        got = kernel(d, grid, ints, K, True, False, (1.0,) * d, None)
        ref = twin(grid, ints, K, True, False, (1.0,) * d, None)
        compare(d, f'{shape} K={K} padded, integer displacements 0 and ±K', got, ref, True)
        ch.compare(fns[d][1], f'{shape} integer displacements: lo == up == value', got[1], got[2], 0.0)
    # --- NaN displacements: the value NaN where any axis' displacement is, lo / up ±3.4e38 there, as JAX gives;
    #     against the twin, NaN patterns equal, every halo form, K = 1 and 2, both row routes of K6 ---
    for d, shape in ((3, SMALL), (3, K6_RAGGED), (2, (37, 45))):
        scale = (0.8, -1.1, 0.6)[:d]
        for K in (1, 2):
            for mode in (None, 'const', 'edge', 'wrap'):
                gshape = tuple(n + 2 * K for n in shape) if mode is None else shape
                grid = torch.randn(gshape, generator=gen, device=dev)
                disps, _ = _with_nan(list((torch.rand((d,) + shape, generator=gen, device=dev) * 2 - 1)
                                          * ((K + 1) / 0.6)), gen)
                for extrema in (False, True):
                    case = f'{shape} K={K} {mode or "padded"}{" extrema" if extrema else ""}, NaN displacements'
                    got = kernel(d, grid, disps, K, extrema, False, scale, mode, 0.25)
                    ref = twin(grid, disps, K, extrema, False, scale, mode, 0.25)
                    got, ref = (got, ref) if extrema else ((got,), (ref,))
                    ch.compare_with_nan(fns[d][1], case + ' value', got[0], ref[0], 1e-5)
                    for what, g, r in zip(('lo', 'up'), got[1:], ref[1:]):
                        ch.compare(fns[d][1], f'{case} {what} (exact)', g, r, 0.0)
    if quick:
        return
    # --- the paths' shapes: a velocity component (constant halo, no extrema)
    #     and the smoke's forward pass (edge halo, extrema), as a step calls them ---
    for d, shape in ((3, (PATH_N,) * 3), (2, (PATH_N_2D,) * 2)):
        name = fns[d][1]
        scale = (-0.5,) * d
        grid = torch.rand(shape, generator=gen, device=dev)
        disps = [torch.rand(shape, generator=gen, device=dev) * 5.0 - 2.5 for _ in range(d)]  # clips at ±1
        out_bytes = nbytes(grid)
        for K in (1, 2):
            got = kernel(d, grid, disps, K, True, False, scale, 'edge')
            ref = twin(grid, disps, K, True, False, scale, 'edge')
            compare(d, f'{shape} K={K} edge extrema', got, ref, True)
            del got, ref
        K = 1
        got = kernel(d, grid, disps, K, False, False, scale, 'const')
        ref = twin(grid, disps, K, False, False, scale, 'const')
        compare(d, f'{shape} K={K} const', got, ref, False)
        # corners: a weight product of d−1 multiplies, one FMA; the tent weights 4 ops per tap
        ops = (2 ** d * (d + 1) + 8 * d) * grid.numel()
        lib = _grid_sample_lookup(grid, disps, K, scale, 'zeros')
        print(f'note  {name:17s} grid_sample (zeros padding) vs twin, const halo 0: '
              f'max |diff| {float((lib() - ref).abs().max()):.2e}')
        ch.time(name, f'velocity component: const halo, no extrema, {shape} K=1',
                lambda: kernel(d, grid, disps, K, False, False, scale, 'const'),
                lambda: twin(grid, disps, K, False, False, scale, 'const'),
                nbytes(grid, *disps) + out_bytes, ops, lib)
        del lib
        lib = _grid_sample_lookup(grid, disps, K, scale, 'border')
        ch.time(name, f'smoke forward: edge halo + extrema, {shape} K=1',
                lambda: kernel(d, grid, disps, K, True, False, scale, 'edge'),
                lambda: twin(grid, disps, K, True, False, scale, 'edge'),
                nbytes(grid, *disps) + 3 * out_bytes, ops + 2 ** (d + 1) * grid.numel(), lib,
                key=name + ' +extrema')
        # the padded route (mode None): the grid padded by K cells, as the mixed and mirror boundaries hand it
        # over (an open box's velocity component); the library call samples the same padded grid
        padded = torch.nn.functional.pad(grid[(None,) * (5 - d)] if d == 3 else grid[None, None],
                                         (K,) * (2 * d), mode='replicate').reshape(tuple(n + 2 * K for n in shape))
        got = kernel(d, padded, disps, K, False, False, scale, None)
        ref = twin(padded, disps, K, False, False, scale, None)
        compare(d, f'{shape} K={K} padded', got, ref, False)
        lib = _grid_sample_lookup(padded, disps, K, scale, 'border', pad=K)
        print(f'note  {name:17s} grid_sample of the padded grid vs twin, padded route: '
              f'max |diff| {float((lib() - ref).abs().max()):.2e}')
        ch.time(name, f'velocity component: padded (mixed sides), no extrema, {shape} K=1',
                lambda: kernel(d, padded, disps, K, False, False, scale, None),
                lambda: twin(padded, disps, K, False, False, scale, None),
                nbytes(padded, *disps) + out_bytes, ops, lib, key=name + ' padded')
        ch.attach(name, [name + ' +extrema', name + ' padded'])
        del lib, grid, disps, got, ref, padded
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 4 and 5: the paths
# ---------------------------------------------------------------------------

def _stepper(model, per_phase, native=False):
    """One SmokePlume step through the model's public methods: `step` (the
    fused path at these sizes), or the three phases in turn — what `step`
    does wherever the fused path does not apply. On Fields, JAX's face,
    unless `native`: then the `_native` methods on the raw tensors. Returns
    (step, advection)."""
    suffix = '_native' if native else ''
    if not per_phase:
        return getattr(model, 'step' + suffix), getattr(model, '_fused_advect' + suffix)
    advect_smoke, advect_velocity, project = (getattr(model, name + suffix)
                                              for name in ('advect_smoke', 'advect_velocity', 'project'))

    def phases(v, s):
        s = advect_smoke(v, s)
        return advect_velocity(v, s), s

    def step(v, s, p):
        v, s = phases(v, s)
        v, p = project(v, p)
        return v, s, p
    return step, phases


def _tensors(state):
    """The torch tensors of a nested array state, in order (obstacles left out)."""
    import torch
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, (tuple, list)):
        return [t for x in state for t in _tensors(x)]
    return []


CG_KERNELS = ('poisson_stencil', 'poisson_stencil_masked', 'poisson_stencil_coeffs', 'jacobi_sweeps',
              'residual_restrict', 'prolong_add')


def field_against_native(tag, model, field_step, native_step, state, steps=2, rel_tol=0.0, cg_apart=0):
    """`steps` steps of the model's Field step and of its `step_native` from
    one Field state on the card (`state_natives` hands the same tensors to
    the array layer): every array bit-equal (`rel_tol` 0) or within `rel_tol`
    of its max |·| with NaN in the same places, the CG counts at most
    `cg_apart` apart, and the same launches of every kernel a step — of the
    kernels the CG's iterations drive, where the counts agree."""
    import torch
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.ops import _build
    native = model.state_natives(*state)
    torch.cuda.synchronize()
    _build.reset_launches()
    with math.SolveTape() as tape:
        for _ in range(steps):
            state = field_step(*state)
    torch.cuda.synchronize()
    field_launches, field_iters = dict(_build.LAUNCHES), [info.iterations for info in tape]
    _build.reset_launches()
    native_iters = []
    for _ in range(steps):
        native = native_step(*native)
        native_iters.append(model.last_solve.iterations)
    torch.cuda.synchronize()
    native_launches = dict(_build.LAUNCHES)
    errs = []
    for got, ref in zip(_tensors(model.state_natives(*state)), _tensors(native)):
        same_nan = bool((torch.isnan(got) == torch.isnan(ref)).all()) and got.shape == ref.shape
        finite = ~torch.isnan(ref)
        err = float((got[finite] - ref[finite]).abs().max()) if same_nan else float('inf')
        errs.append((err, float(ref[finite].abs().max())))
    ok_values = all(e <= rel_tol * scale for e, scale in errs)
    ok_cg = len(field_iters) == len(native_iters) and all(abs(a - b) <= cg_apart for a, b in zip(field_iters, native_iters))
    compared = [k for k in KERNELS if field_iters == native_iters or k not in CG_KERNELS]
    wrong = {k: (field_launches.get(k, 0), native_launches.get(k, 0)) for k in compared
             if field_launches.get(k, 0) != native_launches.get(k, 0)}
    bit_equal = all(e == 0 for e, _ in errs)
    print(f'{tag} field vs native on the card, {steps} steps from one state: max |field - native| '
          + ', '.join(f'{e:.2e} (of {scale:.3e})' for e, scale in errs)
          + f'; bit-equal: {bit_equal}; CG iterations field {field_iters} native {native_iters}; launches a step '
          + ', '.join(f'{k}={field_launches.get(k, 0) / steps:g}/{native_launches.get(k, 0) / steps:g}'
                      for k in KERNELS if field_launches.get(k, 0) or native_launches.get(k, 0))
          + f' (field/native); tol {"bit-equal" if rel_tol == 0 else f"{rel_tol:.0e} of each max"}, CG at most '
          f'{cg_apart} apart: ' + ('ok' if ok_values and ok_cg and not wrong else 'FAIL'))
    if not (ok_values and ok_cg and not wrong):
        raise RuntimeError(f'{tag}: Field and native steps disagree on the card: {errs}, CG {field_iters} vs '
                           f'{native_iters}, launches (field, native) {wrong}')


def alternating_host_ms(tag, field_step, field_state, native_step, native_state, rounds=3, steps_a_round=3):
    """Host-clock ms/step of the Field step and of `step_native`, alternating
    in one process (`rounds` × `steps_a_round` steps each, synchronised
    around each round; medians)."""
    import torch
    times = {'native': [], 'field': []}
    states = {'native': native_state, 'field': field_state}
    steppers = {'native': native_step, 'field': field_step}
    for _ in range(rounds):
        for kind in ('native', 'field'):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps_a_round):
                states[kind] = steppers[kind](*states[kind])
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - t0) / steps_a_round * 1e3)
    a, f = statistics.median(times['native']), statistics.median(times['field'])
    print(f'{tag} field vs native host clock, alternating {rounds} rounds of {steps_a_round} steps: native '
          f'{a:.2f} ms/step {[round(t, 2) for t in times["native"]]}, field {f:.2f} ms/step '
          f'{[round(t, 2) for t in times["field"]]}; field / native {f / a:.3f}')


def run_slice(tag, dims, N, per_phase, required, warmup=2, steps=5):
    """A SmokePlume path on the card through its Field face, as JAX's users
    call it, then against `step_native` (`field_against_native`, bit-equal)."""
    import torch
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.field import divergence_native
    from phiflow_tpu_torch.models import SmokePlume
    from phiflow_tpu_torch.ops import _build
    model = SmokePlume(resolution=N, dims=dims, cg_tol=1e-3, max_iterations=100, device='cuda')
    step, advect = _stepper(model, per_phase)
    size = f'{N}^{dims}'
    v, s, p = model.initial_state()
    for _ in range(warmup):
        v, s, p = step(v, s, p)
    torch.cuda.synchronize()
    _build.reset_launches()
    with math.SolveTape() as tape:
        t0 = time.perf_counter()
        for _ in range(steps):
            v, s, p = step(v, s, p)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    iters = [info.iterations for info in tape]
    launches = dict(_build.LAUNCHES, steps=steps)
    ms = elapsed / steps * 1e3
    print(f'{tag} {size}: {ms:.2f} ms/step, {N ** dims / (ms * 1e-3) / 1e6:.1f} Mcells/s over {steps} Field steps '
          f'after {warmup} warm-up steps; CG iterations per step {iters}')
    print(f'{tag} launches per step: ' + ', '.join(f'{k}={launches.get(k, 0) / steps:g}' for k in KERNELS))
    missing = [k for k in required if launches.get(k, 0) == 0]
    if missing:
        raise RuntimeError(f'{tag}: kernels not launched on the path: {missing}')
    if dims == 3:
        # K2 on each smoothed level of each V-cycle (one a solve and one a CG iteration); K5: one launch a fused
        # call, three a step
        expected = {'jacobi_sweeps': K2_LAUNCHES_PER_LEVEL * smoothed_levels(N) * sum(1 + it for it in iters)}
        if per_phase:
            expected['window_interp_3d'] = K6_LAUNCHES_PER_PHASE_STEP * steps
        else:
            expected['fused_advect'] = FUSED_CALLS_PER_STEP * steps
        wrong = {k: (launches.get(k, 0), e) for k, e in expected.items() if launches.get(k, 0) != e}
        if wrong:
            raise RuntimeError(f'{tag}: launches on the path (counted, expected): {wrong}')
    # the advection / pressure split, from 3 more steps timed phase by phase
    adv, prs = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v2, s = advect(v, s)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        v, p = model.project(v2, p)
        torch.cuda.synchronize()
        adv.append((t1 - t0) * 1e3)
        prs.append((time.perf_counter() - t1) * 1e3)
    print(f'{tag} split: advection {statistics.median(adv):.2f} ms, pressure {statistics.median(prs):.2f} ms '
          f'(median of 3 steps timed phase by phase)')
    vel, smoke, pressure = model.state_natives(v, s, p)
    div = float(divergence_native(vel, model._dx).abs().max())
    disp = max(float(c.abs().max()) for c in vel) * model.dt / model._dx
    finite = all(bool(torch.isfinite(t).all()) for t in (*vel, smoke, pressure))
    print(f'{tag} max |div| after projection {div:.3e}; max |displacement| <= {disp:.3f} cells '
          f'(max|v|·dt/dx; certified <= max_cells={model.max_cells}: {disp <= model.max_cells}); '
          f'all finite: {finite}; max smoke {float(smoke.max()):.4f}')
    comps, cells = model._shapes()
    shapes_ok = [tuple(t.shape) for t in vel] == comps and tuple(smoke.shape) == cells and tuple(pressure.shape) == cells
    if not (finite and shapes_ok and disp <= model.max_cells and div < 0.1):
        raise RuntimeError(f'{tag} output wrong: finite={finite} shapes_ok={shapes_ok} disp={disp} div={div}')
    native_step, _ = _stepper(model, per_phase, native=True)
    field_against_native(tag, model, step, native_step, (v, s, p))
    if tag == 'fused':
        alternating_host_ms(f'{tag} {size}', step, (v, s, p), native_step, model.state_natives(v, s, p))
    return launches, (v, s, p), iters


def run_flip(tag, N, warmup=2, steps=5):
    """FlipLiquid(N, dims=3).step on the card through its Field face: the
    launch counts of a timed run, the split by phase (the array layer's
    phases), the gates on what comes out, then against `step_native`
    (`field_against_native`: K8's atomics sum in varying order, so within
    1e-5 of each array's max and CG counts at most 1 apart)."""
    import torch
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.field import divergence_native
    from phiflow_tpu_torch.models import FlipLiquid
    from phiflow_tpu_torch.ops import _build
    model = FlipLiquid(N, dims=3, points_per_cell=8, device='cuda')
    particles, pressure = model.initial_state()
    n = int(particles.points.shape.get_size('points'))
    height = lambda particles: float(particles.points.vector['z'].torch().mean())
    z0 = height(particles)
    for _ in range(warmup):
        particles, pressure = model.step(particles, pressure)
    torch.cuda.synchronize()
    z_warm = height(particles)
    _build.reset_launches()
    with math.SolveTape() as tape:
        t0 = time.perf_counter()
        for _ in range(steps):
            particles, pressure = model.step(particles, pressure)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES, steps=steps)
    ms = elapsed / steps * 1e3
    iters = [info.iterations for info in tape]
    print(f'{tag} {N}^3, {n} particles: {ms:.2f} ms/step, {n / (ms * 1e-3) / 1e6:.2f} M particles/s over {steps} '
          f'Field steps after {warmup} warm-up steps; CG iterations per step {iters}, converged '
          f'{[info.converged for info in tape]} (cg_tol {model.cg_tol}, at most {model.max_iterations})')
    print(f'{tag} launches per step: ' + ', '.join(f'{k}={launches.get(k, 0) / steps:g}' for k in KERNELS))
    # K1m: two diagonal probes, A·x0 and the first preconditioner's three a solve, four an iteration
    expected = {'p2g': P2G_LAUNCHES_PER_STEP * steps, 'p2g_mean': P2G_LAUNCHES_PER_STEP * steps,
                'poisson_stencil_masked': sum(6 + 4 * it for it in iters)}
    expected['poisson_stencil'] = expected['poisson_stencil_masked']
    wrong = {k: (launches.get(k, 0), e) for k, e in expected.items() if launches.get(k, 0) != e or e == 0}
    if wrong:
        raise RuntimeError(f'{tag}: launches on the path (counted, expected): {wrong}')
    # the split, from 3 more steps timed phase by phase through the array layer's phases
    split = {'P2G + fill': [], 'projection': [], 'G2P + RK4 + push': []}
    div_active = 0.0
    native, native_pressure = model.state_natives(particles, pressure)
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prev_v, occupied = model.particles_to_grid_native(native)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grid_v, native_pressure = model.project_native(prev_v, occupied, native_pressure)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        native = model.grid_to_particles_native(native, grid_v, prev_v)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
            split[key].append(dt * 1e3)
        div = divergence_native(grid_v, model._dx) * occupied
        div_active = max(div_active, float(torch.nan_to_num(div, nan=0.0).abs().max()))
    print(f'{tag} split: ' + ', '.join(f'{k} {statistics.median(v):.2f} ms' for k, v in split.items())
          + ' (median of 3 steps timed phase by phase, the array layer\'s phases)')
    particles, pressure = model.state_fields(native, native_pressure)
    positions, velocities = native
    z1 = height(particles)
    finite = bool(torch.isfinite(positions).all()) and bool(torch.isfinite(native_pressure).all())
    inside = bool((positions > -0.5).all()) and bool((positions < N + 0.5).all())
    kept = tuple(positions.shape) == (n, 3) and tuple(velocities.shape) == (n, 3) \
        and tuple(native_pressure.shape) == (N,) * 3
    print(f'{tag} max |div·active| after projection {div_active:.3e}; mean height {z0:.3f} at rest, {z_warm:.3f} '
          f'after the warm-up, {z1:.3f} at the end; positions finite: {finite}, inside the box ± 0.5: {inside}, '
          f'{int(torch.isnan(velocities).any(dim=1).sum())} particles with a NaN velocity')
    if not (finite and inside and kept and z1 < z_warm < z0):
        raise RuntimeError(f'{tag} output wrong: finite={finite} inside={inside} kept={kept} heights {z0} {z_warm} {z1}')
    field_against_native(tag, model, model.step, model.step_native, (particles, pressure), rel_tol=1e-5, cg_apart=1)
    if N == FLIP_N[0]:
        alternating_host_ms(f'{tag} {N}^3', model.step, (particles, pressure), model.step_native,
                            model.state_natives(particles, pressure))
    return launches


PORT_KERNELS = ('stencil_kernel', 'smooth_kernel', 'residual_restrict_kernel', 'prolong_add_kernel',
                'fused_advect_kernel', 'advect_lift_kernel', 'window_interp_kernel', 'window_interp_disp_grad_kernel',
                'window_interp_grid_grad_kernel', 'p2g_scatter_kernel', 'p2g_mean_kernel')


TERRAIN_N = 128  # terrain-flip-128: a 3D version of examples/terrain_flip.py at FLIP's full width
TWO_PI = 6.283185307179586


def terrain_setup(N, device):
    """terrain-flip's state at N³ unit cells in a closed box: the heightmap h = 24 + 16 sin(2πx/128) + 8
    cos(2πy/128) at 128³ (scaled by N / 128; max_dist 4) and the liquid block Box['x,y,z', 16:80, 16:80, 56:96]
    above its highest point, 8 particles a cell at rest (1,310,720 at 128³). Returns (domain, terrain,
    particles)."""
    from phiflow_tpu_torch import field, geom, math
    s = N / 128
    with math.default_device(device):
        domain = geom.Box(x=N, y=N, z=N)
        xs = math.linspace(0., N, math.spatial(x=N + 1))
        ys = math.linspace(0., N, math.spatial(y=N + 1))
        heights = 24 * s + 16 * s * math.sin(xs / N * TWO_PI) + 8 * s * math.cos(ys / N * TWO_PI)
        terrain = geom.Heightmap(heights, domain, max_dist=4.)
        block = geom.Box['x,y,z', 16 * s:80 * s, 16 * s:80 * s, 56 * s:96 * s]
        particles = field.distribute_points(block, x=N, y=N, z=N) * (0, 0, 0)
    return domain, terrain, particles


def flip_solid_step(N, domain, solid, particles, dt=0.1):
    """One step of examples/terrain_flip.py in 3D through the port's Field functions, up to the push: P2G (K8)
    with outside_handling='clamp', finite_fill, the occupied cells, make_incompressible with the solid (a
    heightmap, a spline chute) as an Obstacle and `active` the occupied cells (CG at 1e-4, the Chebyshev masked
    preconditioner: K1m with mA + c0 + active), the FLIP update, advect.points with finite_rk4. Returns
    (particles, the projected velocity, the occupied cells, the solve's iterations); `solid_push` ends the step."""
    from phiflow_tpu_torch import field, math
    from phiflow_tpu_torch.physics import advect, fluid
    grid_v = prev_v = field.finite_fill(field.resample(particles, field.StaggeredGrid(0, 0, domain, x=N, y=N, z=N),
                                                       scatter=True, outside_handling='clamp'))
    occupied = field.resample(field.mask(particles), field.CenteredGrid(0, grid_v.boundary.spatial_gradient(), domain,
                                                                        x=N, y=N, z=N), scatter=True)
    with math.SolveTape() as tape:
        grid_v, _ = fluid.make_incompressible(grid_v + (0, 0, -9.81 * dt), [fluid.Obstacle(solid)], active=occupied,
                                              solve=math.Solve('CG', 1e-4, suppress=(math.ConvergenceException,)))
    particles = particles + field.resample(grid_v - prev_v, particles)
    particles = advect.points(particles, grid_v, dt, advect.finite_rk4)
    return particles, grid_v, occupied, [int(info.iterations) for info in tape]


def solid_push(domain, solid, particles):
    """The step's end: boundary_push out of the solid and into the domain."""
    from phiflow_tpu_torch.physics import fluid
    return fluid.boundary_push(particles, [solid, ~domain])


def terrain_step(N, domain, solid, particles, dt=0.1):
    """One step of terrain-flip-128 (the solid the heightmap) or spline-flip-128 (the spline chute):
    `flip_solid_step`, then `solid_push`. Returns what `flip_solid_step` returns, the particles pushed."""
    particles, grid_v, occupied, its = flip_solid_step(N, domain, solid, particles, dt)
    return solid_push(domain, solid, particles), grid_v, occupied, its


def _terrain_gaps(points, N):
    """Each point's height above the terrain (examples/terrain_flip.py's heightmap), in cells; `points` an (n, 3)
    torch tensor."""
    import torch
    p = points.float()
    s = N / 128
    h = 24 * s + 16 * s * torch.sin(p[:, 0] / N * TWO_PI) + 8 * s * torch.cos(p[:, 1] / N * TWO_PI)
    return p[:, 2] - h


def query_split(N, domain, solid, particles):
    """One more `terrain_step` with cuda.synchronize around each of the solid's queries inside it: the masks
    make_incompressible makes of it (`fluid.geometry_mask`: the accessible cells, the faces' soft masks) and its
    push in boundary_push. Returns (the step's ms, the masks' ms, the push's ms), all on the host clock within
    that one step, so the queries' share of it is at most 1."""
    import torch
    from phiflow_tpu_torch.physics import fluid
    spent = {'masks': 0., 'push': 0.}

    def timed(kind, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                spent[kind] += time.perf_counter() - t
        return call

    cls, mask = type(solid), fluid.geometry_mask
    own_push = vars(cls).get('push')
    fluid.geometry_mask, cls.push = timed('masks', mask), timed('push', cls.push)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        terrain_step(N, domain, solid, particles)
        torch.cuda.synchronize()
        step = time.perf_counter() - t0
    finally:
        fluid.geometry_mask = mask
        if own_push is None:
            del cls.push
        else:
            cls.push = own_push
    return step * 1e3, spent['masks'] * 1e3, spent['push'] * 1e3


def run_solid_flip(tag, setup, gaps, witness, N, settle=20, warmup=2, steps=5):
    """terrain-flip-128 or spline-flip-128 (`terrain_step` on `setup(N, 'cuda')`'s domain, solid and particles):
    `settle` steps from rest, so that the liquid lies on the solid (the projection works around it and the push
    moves particles out of it), then `warmup` + `steps` steps on the card, the counters set to 0 just before the
    timed steps and read just after, then 2 steps under torch.profiler and one more timed query by query
    (`query_split`). Prints ms/step on the host clock, the device's kernel time a step (the profiler's), the
    solid's queries' split of a step, K8 and K1m launches a step (every step; no other kernel launched: every
    stencil launch the masked form), the CG iterations (> 0), the largest |div| over the occupied cells whose
    centre lies more than 2.5 cells from the solid (< 1: none of their faces is cut), the share of particles at
    a gap ≥ −1 cell (≥ 97%, as the example asserts) and within one cell of the surface (> 1%: the liquid lies on
    the solid). `gaps(points, N)` is a point's gap to the solid in cells (a height above the terrain, the
    chute's signed distance). Then `witness()`, the step on the CPU against the card."""
    import torch
    from phiflow_tpu_torch import field
    from phiflow_tpu_torch.ops import _build
    domain, solid, particles = setup(N, 'cuda')
    n = int(particles.points.shape.get_size('points'))
    for _ in range(settle + warmup):
        particles, *_ = terrain_step(N, domain, solid, particles)
    torch.cuda.synchronize()
    _build.reset_launches()
    iters = []
    t0 = time.perf_counter()
    for _ in range(steps):
        particles, grid_v, occupied, its = terrain_step(N, domain, solid, particles)
        iters.append(its)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    launches = dict(_build.LAUNCHES, steps=steps)
    active = occupied.values.native(('x', 'y', 'z')) > 0
    d = field.divergence(grid_v).values.native(('x', 'y', 'z'))
    # cells the solid cuts hold the divergence of the open face fractions' flux, not of the velocity: the gate
    # reads the occupied cells whose centre lies more than 2.5 cells from the solid
    c = torch.arange(N, device='cuda', dtype=torch.float32) + 0.5
    centres = torch.stack(torch.meshgrid(c, c, c, indexing='ij'), -1).reshape(-1, 3)
    clear = active & (gaps(centres, N).reshape(N, N, N) > 2.5)
    div = float(torch.where(clear, d, torch.zeros_like(d)).abs().max())
    div_all = float(torch.where(active, d, torch.zeros_like(d)).abs().max())
    g = gaps(particles.points.native(('points', 'vector')), N)
    outside, contact = float((g >= -1.0).float().mean()), float((g.abs() < 1.0).float().mean())
    finite = bool(torch.isfinite(particles.points.native(('points', 'vector'))).all())
    del grid_v, occupied, d, active, clear, g, centres
    device_ms, wall_ms = profile_path(tag, f'{N}^3', lambda p: terrain_step(N, domain, solid, p)[0], particles,
                                      warmup=0, steps=2, rows_shown=8)
    step_ms, mask_ms, push_ms = query_split(N, domain, solid, particles)
    print(f'{tag} {N}^3, {n} particles: {ms:.2f} ms/step host clock over {steps} steps after {settle} settling and '
          f'{warmup} warm-up, {device_ms:.2f} ms/step device busy (torch.profiler over 2 more steps, {wall_ms:.2f} '
          f'ms/step wall under it); CG iterations per step {iters} (CG 1e-4, Chebyshev masked preconditioner)')
    print(f'{tag} the solid\'s queries in one more step, cuda.synchronize around each inside it: its masks '
          f'(accessible cells + faces\' soft masks, {4 * N ** 3:,} points) {mask_ms:.2f} ms, its push ({n:,} '
          f'particles) {push_ms:.2f} ms, of a step of {step_ms:.2f} ms: {100 * (mask_ms + push_ms) / step_ms:.1f}%')
    print(f'{tag} launches per step: ' + ', '.join(f'{k}={launches.get(k, 0) / steps:g}' for k in KERNELS))
    print(f'{tag} max |div| over the occupied cells more than 2.5 cells from the solid {div:.3e} (over all the '
          f'occupied cells {div_all:.3e}: the solid cuts some); {outside * 100:.2f}% of the particles at a gap >= -1 '
          f'cell, {contact * 100:.2f}% within one cell of the surface; finite: {finite}')
    path = ('p2g', 'p2g_mean', 'poisson_stencil_masked')
    # the masked stencil also counts under the stencil's and the coefficient form's names (K1m itself): every
    # stencil launch must be the masked form with the solid's coefficients
    others = {k: v for k, v in launches.items()
              if k not in path + ('poisson_stencil', 'poisson_stencil_coeffs', 'steps') and v}
    if (any(launches.get(k, 0) < steps for k in path) or others
            or not launches['poisson_stencil'] == launches['poisson_stencil_masked']
            == launches.get('poisson_stencil_coeffs', 0)):
        raise RuntimeError(f'{tag}: K8 / K1m not launched every step, an unmasked K1 or other kernels launched: '
                           f'{launches}')
    if not (finite and outside >= 0.97 and contact > 0.01 and div < 1.0 and min(sum(i) for i in iters) > 0):
        raise RuntimeError(f'{tag} output wrong: finite={finite} outside={outside} contact={contact} div={div} '
                           f'CG {iters}')
    del particles
    torch.cuda.empty_cache()
    witness()
    return launches


def solid_flip_cpu_vs_card(tag, setup, gaps, solids, cpu_n=32, cpu_settle=10):
    """`cpu_settle` steps of `terrain_step` at cpu_n³ on the CPU from `setup`, so that the liquid lies on the
    solid, then one more step on the CPU and on the card from that state with each solid of `solids` ({label:
    (make(n, device) or None for the setup's own, held)}). Held: positions and velocities before the push and
    positions after it within FLIP's 5e-4 of their scale, CG counts > 0 and at most 1 apart; the others printed
    (finite). Returns {(label, device): [positions and velocities before the push, positions after it, the CG
    counts]}, on the host."""
    from phiflow_tpu_torch import math as tmath
    from phiflow_tpu_torch.models import to_device
    with tmath.default_device('cpu'):
        dom, sol, parts = setup(cpu_n, 'cpu')
        for _ in range(cpu_settle):
            parts, *_ = terrain_step(cpu_n, dom, sol, parts)
    contact = float((gaps(parts.points.native(('points', 'vector')), cpu_n).abs() < 1.0).double().mean())
    n = int(parts.points.shape.get_size('points'))
    out = {}
    for label, (make, held) in solids.items():
        for dev in ('cpu', 'cuda'):
            with tmath.default_device(dev):
                dom, sol, _ = setup(cpu_n, dev)
                sol = sol if make is None else make(cpu_n, dev)
                pre, _, _, its = flip_solid_step(cpu_n, dom, sol, to_device(parts, dev))
                post = solid_push(dom, sol, pre)
                out[label, dev] = [pre.points.native(('points', 'vector')).cpu(),
                                   pre.values.native(('points', 'vector')).cpu(),
                                   post.points.native(('points', 'vector')).cpu(), its]
        (*card, card_cg), (*cpu, cpu_cg) = out[label, 'cuda'], out[label, 'cpu']
        errs = [_relative(a, b) for a, b in zip(card, cpu)]
        parted = int(((card[2] - cpu[2]).abs().amax(-1) > 5e-4 * float(cpu[2].abs().max())).sum())
        print(f'{tag} CPU against the card at {cpu_n}^3, one step after {cpu_settle} on the CPU ({contact * 100:.2f}% '
              f'of the particles within one cell of the solid), {label}: before the push positions / velocities '
              f'{errs[0]:.2e} / {errs[1]:.2e} of their scale, after it positions {errs[2]:.2e} ({parted} of {n} '
              f'particles parted by more than 5e-4 of the scale), CG {cpu_cg} / {card_cg}'
              + (' (tolerance 5e-4, CG at most 1 apart)' if held else ' (printed)'))
        if (contact <= 0.01 or min(sum(cpu_cg), sum(card_cg)) == 0 or not all(e < float('inf') for e in errs)
                or held and (max(errs) > 5e-4 or any(abs(a - b) > 1 for a, b in zip(cpu_cg, card_cg)))):
            raise RuntimeError(f'{tag} {label}: CPU and card differ, or the state is not on the solid: {errs}, '
                               f'contact {contact}, CG {cpu_cg} / {card_cg}')
    return out


def check_geometry_on_card(n=1_000_000):
    """Each geometry of the port's geometry layer at `n` random points on the card against the same points on
    the CPU: lies_inside equal but within 1e-4 of the surface, the signed distance within 1e-4 of its scale,
    push (along the finite-difference normal) within 1e-3 of the domain."""
    import torch
    from phiflow_tpu_torch import geom, math as tmath
    shapes = {
        'Box': lambda: geom.Box(x=(2, 5), y=(1, 6), z=(0, 4)),
        'Cuboid': lambda: geom.Cuboid(tmath.vec(x=4., y=4., z=4.), half_size=tmath.vec(x=2., y=1., z=1.5),
                                      rotation=tmath.vec(x=0.3, y=0.2, z=0.5)),
        'Sphere': lambda: geom.Sphere(x=4, y=4, z=4, radius=2.5),
        'Cylinder': lambda: geom.cylinder(x=4, y=4, z=4, radius=2., depth=3., axis='z').rotated(
            tmath.vec(x=0.4, y=0.2, z=0.)),
        'Heightmap': lambda: geom.Heightmap(2 + tmath.sin(tmath.linspace(0., 8., tmath.spatial(x=33)))
                                            * tmath.cos(tmath.linspace(0., 8., tmath.spatial(y=33))),
                                            geom.Box(x=8, y=8, z=8), max_dist=4.),
        'SDF': lambda: geom.SDF(lambda p: tmath.vec_length(p - tmath.vec(x=4., y=4., z=4.)) - 2.,
                                geom.Box(x=(2, 6), y=(2, 6), z=(2, 6))),
        'SDFGrid': lambda: geom.sample_sdf(geom.Sphere(x=4, y=4, z=4, radius=2.5), geom.Box(x=8, y=8, z=8),
                                           x=32, y=32, z=32),
        'union': lambda: geom.union(geom.Box(x=(1, 3), y=(1, 7), z=(0, 3)), geom.Sphere(x=6, y=5, z=5, radius=1.5)),
        'intersection': lambda: geom.intersection(geom.Box(x=(1, 7), y=(1, 7), z=(0, 5)),
                                                  geom.Sphere(x=4, y=4, z=2, radius=3.)),
        'infinite_cylinder': lambda: geom.infinite_cylinder(x=4, y=4, radius=2., inf_dim='z'),
    }
    gen = torch.Generator(device='cuda')
    gen.manual_seed(3)
    pts = torch.rand((n, 3), generator=gen, device='cuda') * 8
    for name, make in shapes.items():
        res = {}
        for dev in ('cuda', 'cpu'):
            with tmath.default_device(dev):
                shape = make()
                loc = tmath.tensor(pts.to(dev), tmath.instance('p'), tmath.channel(vector='x,y,z'))
                res[dev] = [shape.lies_inside(loc).native('p'), shape.approximate_signed_distance(loc).native('p'),
                            shape.push(loc, shift_amount=0.1).native(('p', 'vector'))]
        (gi, gd, gp), (ci, cd, cp) = [[t.cpu() for t in res[k]] for k in ('cuda', 'cpu')]
        near = cd.abs() < 1e-4
        inside_ok = bool(((gi == ci) | near).all())
        d_err = float((gd - cd).abs().max() / cd.abs().max())
        p_err = float((gp - cp).abs().max() / 8)
        ok = inside_ok and d_err < 1e-4 and p_err < 1e-3
        print(f'check geometry         {name:17s} at {n} points: inside equal {inside_ok}, signed distance '
              f'{d_err:.2e} of its scale, push {p_err:.2e} of the domain {"ok" if ok else "FAIL"}')
        if not ok:
            raise RuntimeError(f'geometry {name}: card and CPU differ')


def check_obstacles_on_card(N=16):
    """An obstacle of each geometry the layer gained (cylinder, heightmap, SDF, sampled SDF, union,
    intersection, the spline chute) in the Field `make_incompressible` at N³ on the card: K1m (its mA / c0 masks
    from the shape's signed distance) launched, the projected velocity within 1e-4 of its scale of the CPU's and
    the CG counts at most 1 apart. The chute (spline-flip's, scaled to N³ and moved by SPLINE_WITNESS_SHIFT) is
    held so in its float64 witness (`as_float64`: its masks in float64, the projection in float32); with its
    float32 queries (a mask entry that parts moves the whole projection: its gap printed), the chute's masks
    where they are well-conditioned (`hold_float32`)."""
    from phiflow_tpu_torch import field, geom, math as tmath
    from phiflow_tpu_torch.physics import fluid
    from phiflow_tpu_torch.ops import _build
    c = N / 2
    chute = lambda bits: spline_chute(N, tmath.get_default_device(), bits=bits, shift=SPLINE_WITNESS_SHIFT)
    shapes = {
        'cylinder': lambda: geom.cylinder(x=c, y=c, z=c * 0.8, radius=N / 5, depth=N / 3, axis='z'),
        'heightmap': lambda: geom.Heightmap(N / 5 + N / 12 * tmath.sin(tmath.linspace(0., 6., tmath.spatial(x=N + 1)))
                                            * tmath.cos(tmath.linspace(0., 4., tmath.spatial(y=N + 1))),
                                            geom.Box(x=N, y=N, z=N), max_dist=4.),
        'sdf': lambda: geom.SDF(lambda p: tmath.vec_length(p - tmath.vec(x=c, y=c, z=c)) - N / 4,
                                geom.Box(x=(c / 2, 1.5 * c), y=(c / 2, 1.5 * c), z=(c / 2, 1.5 * c))),
        'sdf-grid': lambda: geom.sample_sdf(geom.Sphere(x=c, y=c, z=c, radius=N / 4), geom.Box(x=N, y=N, z=N),
                                            x=N, y=N, z=N),
        'union': lambda: geom.union(geom.Box(x=(N / 6, N / 3), y=(N / 6, 5 * N / 6), z=(0, N / 3)),
                                    geom.Sphere(x=2 * N / 3, y=c, z=c, radius=N / 6)),
        'intersection': lambda: geom.intersection(geom.Box(x=(N / 6, 5 * N / 6), y=(N / 6, 5 * N / 6), z=(0, c)),
                                                  geom.Sphere(x=c, y=c, z=N / 4, radius=N / 3)),
        'spline': lambda: chute(64),
        'spline-float32': lambda: chute(32),
    }
    flow = lambda p: tmath.stack({'x': tmath.sin(p.vector['y'] / 4) + 0.3, 'y': tmath.cos(p.vector['z'] / 5),
                                  'z': tmath.sin(p.vector['x'] / 4) - 0.5}, tmath.channel(vector='x,y,z'))
    out = {}
    for name, make in shapes.items():
        for dev in ('cpu', 'cuda'):
            with tmath.default_device(dev):
                v = field.StaggeredGrid(flow, 0, geom.Box(x=N, y=N, z=N), x=N, y=N, z=N)
                obstacle = make()
                _build.reset_launches()
                with tmath.SolveTape() as tape:
                    v, _ = fluid.make_incompressible(v, [fluid.Obstacle(obstacle)],
                                                     solve=tmath.Solve('CG', 1e-5, 1e-5, max_iterations=1000))
                out[name, dev] = ([v.values.vector[d].native('x,y,z').cpu() for d in 'xyz'], int(tape[0].iterations), _build.LAUNCHES.get('poisson_stencil_masked', 0),
                                  chute_masks(obstacle, N, dev) if name.startswith('spline') else None)
        (cv, ci, _, _), (gv, gi, k1m, _) = out[name, 'cpu'], out[name, 'cuda']
        err = max(_relative(g, c_) for g, c_ in zip(gv, cv))
        held = name != 'spline-float32'
        ok = (not held or err < 1e-4 and abs(ci - gi) <= 1) and k1m > 0 and min(ci, gi) > 0
        print(f'check obstacle         {name:17s} {N}^3 projection: card vs CPU {err:.2e} of scale, CG {gi} / {ci}, '
              f'K1m launched {k1m} times' + ('' if held else ' (printed; its masks held where well-conditioned, below)')
              + f' {"ok" if ok else "FAIL"}')
        if not ok:
            raise RuntimeError(f'obstacle {name}: card and CPU differ or K1m not launched')
    hold_float32(f'obstacle spline {N}^3 masks', [out['spline-float32', 'cuda'][3]], [out['spline-float32', 'cpu'][3]],
                 [out['spline', 'cpu'][3]], FLOAT32_APART['masks'])


def profile_path(tag, size, advance, state, warmup=2, steps=3, rows_shown=12):
    """torch.profiler over `steps` steps of a path (`advance(state) -> state`):
    device time by kernel and the device's busy share of the wall time (the
    profiler's own host overhead included in that wall time), and the
    host→device copies. Returns the device's kernel time and the wall time, in
    ms a step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        state = advance(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state = advance(state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side kernel rows only: a CPU op's row repeats its kernels' time
    rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows)
    ours = [r for r in rows if any(k in r[0] for k in PORT_KERNELS)]
    ours_ms = sum(r[2] for r in ours)
    kernels = sum(r[1] for r in rows) / steps
    htod = sum(r[1] for r in rows if 'HtoD' in r[0]) / steps
    print(f'profile {tag} {size}, {steps} steps: device busy {device_ms / steps:.2f} ms/step of '
          f'{wall_ms / steps:.2f} ms/step wall under the profiler ({100 * device_ms / wall_ms:.1f}% busy); '
          f'the port\'s kernels {ours_ms / steps:.2f} ms/step, PyTorch kernels {(device_ms - ours_ms) / steps:.2f} ms/step, '
          f'{kernels:.0f} device kernels a step, {htod:g} host->device copies a step')
    for key, count, ms in rows[:rows_shown]:
        print(f'profile   {ms / steps:8.3f} ms/step {count / steps:7.1f} calls/step  {key[:110]}')
    for key, count, ms in ours:
        print(f'profile   the port\'s {key.split("(")[0][:70]}: {1e3 * ms / count:.2f} us a launch, '
              f'{count / steps:.1f} launches a step')
    return device_ms / steps, wall_ms / steps


def profile_flip(tag, N):
    """A FLIP Field step and a `step_native`, and the array layer's P2G +
    fill alone (its device kernels do not follow the CG's iteration count)."""
    from phiflow_tpu_torch.models import FlipLiquid
    model = FlipLiquid(N, dims=3, points_per_cell=8, device='cuda')
    profile_path(tag, f'{N}^3', lambda state: model.step(*state), model.initial_state())
    profile_path(f'{tag} native', f'{N}^3', lambda state: model.step_native(*state), model.initial_state_native(),
                 rows_shown=8)
    profile_path(f'{tag} P2G + fill', f'{N}^3', lambda state: (model.particles_to_grid_native(state[0]), state)[1],
                 model.initial_state_native(), rows_shown=8)


def profile_slice(tag, dims, N, per_phase):
    """A SmokePlume path's Field step, and its `_native` step from rest."""
    from phiflow_tpu_torch.models import SmokePlume
    model = SmokePlume(resolution=N, dims=dims, cg_tol=1e-3, max_iterations=100, device='cuda')
    step, _ = _stepper(model, per_phase)
    profile_path(tag, f'{N}^{dims}', lambda state: step(*state), model.initial_state(), rows_shown=16)
    native_step, _ = _stepper(model, per_phase, native=True)
    profile_path(f'{tag} native', f'{N}^{dims}', lambda state: native_step(*state), model.initial_state_native(),
                 rows_shown=8)


def profile_obstacles(tag, N, preconditioner='chebyshev'):
    step = obstacle_stepper(N, preconditioner=preconditioner)[0]
    profile_path(tag, f'{N}^3', lambda state: step(*state)[0], obstacle_state(N, 'cuda'))


def smooth_state(N, dims=3, seed=0, period=None):
    """A smooth random closed-box state: low-mode sinusoids of 1–3 waves a
    `period` cells (N by default), |v|·dt/dx ≤ 0.6 cells. Returns the
    velocity components, smoke and pressure: fresh copies of arrays made
    once for each argument set (several phases start from the same state)."""
    return tuple(a.copy() for a in _smooth_state(N, dims, seed, period))


@functools.lru_cache(maxsize=6)
def _smooth_state(N, dims, seed, period):
    import numpy as np
    rng = np.random.default_rng(seed)

    def field(shape, amp):
        # each mode a product of one sine an axis: the sines of the axis coordinates broadcast into the product
        # (in the axes' order, the same float64 numbers as on the whole mesh, N times fewer sines)
        axes = [np.arange(n) / (period or N) for n in shape]
        out = np.zeros(shape)
        for _ in range(4):
            k = rng.integers(1, 4, dims)
            ph = rng.uniform(0, 2 * np.pi, dims)
            term = None
            for a in range(dims):
                wave = np.sin(2 * np.pi * k[a] * axes[a] + ph[a]).reshape([-1 if b == a else 1 for b in range(dims)])
                term = wave if term is None else term * wave
            out += term
        return (amp * out / np.abs(out).max()).astype(np.float32)
    vel = [field(tuple(N - (a == d) for a in range(dims)), 1.2) for d in range(dims)]
    smoke = (0.5 + field((N,) * dims, 0.5)).astype(np.float32)
    return (*vel, smoke, np.zeros((N,) * dims, np.float32))


def cpu_vs_card(tag, dims, N, per_phase, steps=2, tol=1e-3):
    import numpy as np
    from phiflow_tpu_torch.models import SmokePlume, state_from_numpy, state_to_numpy
    arrays = smooth_state(N, dims)
    out = {}
    for dev in ('cpu', 'cuda'):
        model = SmokePlume(resolution=N, dims=dims, cg_tol=1e-3, max_iterations=100, device=dev)
        step, _ = _stepper(model, per_phase, native=True)
        v, s, p = state_from_numpy(*arrays, device=dev)
        for _ in range(steps):
            v, s, p = step(v, s, p)
        out[dev] = state_to_numpy((v, s, p))
    names = [f'v{"xyz"[d]}' for d in range(dims)] + ['smoke']
    errs = {n: float(np.abs(a - b).max()) for n, a, b in zip(names, out['cpu'], out['cuda'])}
    worst = max(errs.values())
    print(f'cpu vs card, {tag} {N}^{dims}, {steps} steps from one numpy state: '
          + ', '.join(f'{n} {e:.2e}' for n, e in errs.items())
          + f'; max {worst:.2e} tol {tol:.0e} {"ok" if worst <= tol else "FAIL"}')
    if not worst <= tol:
        raise RuntimeError(f'CPU and card disagree ({tag}): {errs}')


def flip_cpu_vs_card(N=32, steps=2, tol=1e-3):
    """FLIP steps from one numpy state — the block with a smooth velocity
    field — on the CPU (the twins) and on the card (K8, K1m)."""
    import numpy as np
    from phiflow_tpu_torch.models import FlipLiquid
    from phiflow_tpu_torch.models.flip import state_from_numpy, state_to_numpy
    out = {}
    for dev in ('cpu', 'cuda'):
        model = FlipLiquid(N, dims=3, points_per_cell=8, device=dev)
        pos = model.positions0
        vel = 0.2 * np.stack([np.sin(2 * np.pi * pos[:, (a + 1) % 3] / N) * np.cos(2 * np.pi * pos[:, a] / N)
                              for a in range(3)], axis=1)
        particles, pressure = state_from_numpy(pos, vel, np.zeros((N,) * 3), device=dev)
        iters = []
        for _ in range(steps):
            particles, pressure = model.step_native(particles, pressure)
            iters.append(model.last_solve.iterations)
        out[dev] = state_to_numpy((particles, pressure)) + (iters,)
    errs = {n: float(np.abs(a - b).max()) for n, a, b in zip(('positions', 'velocities', 'pressure'),
                                                            out['cpu'], out['cuda'])}
    ok = errs['positions'] <= tol
    print(f'cpu vs card, flip {N}^3 ({out["cpu"][0].shape[0]} particles), {steps} steps from one numpy state: '
          + ', '.join(f'{n} {e:.2e}' for n, e in errs.items())
          + f'; CG iterations cpu {out["cpu"][3]} card {out["cuda"][3]}; positions tol {tol:.0e} '
          + ('ok' if ok else 'FAIL'))
    if not ok:
        raise RuntimeError(f'CPU and card disagree (flip): {errs}')

# ---------------------------------------------------------------------------
# the Field path: SmokePlume's per-phase step through its Field phase methods
# ---------------------------------------------------------------------------

def run_field(tag, N, state, phase_launches, phase_iters, warmup=2, steps=5):
    """Path 4-field: the model's own Field phase methods (`advect_smoke`,
    `advect_velocity`, `project`: JAX's phases on Fields) at N³ from path
    4b's final state, 2 warm-up steps, then 5 timed with every launch counter
    set to 0 just before and read just after. K6 exactly 5 launches a step;
    K1–K4 as many per V-cycle (1 + CG iterations a step) as on 4b."""
    import torch
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.field import divergence
    from phiflow_tpu_torch.models import SmokePlume
    from phiflow_tpu_torch.ops import _build
    from phiflow_tpu_torch.physics import advect
    model = SmokePlume(resolution=N, dims=3, cg_tol=1e-3, max_iterations=100, device='cuda')
    v, s, p = state
    step, _ = _stepper(model, True)
    for _ in range(warmup):
        v, s, p = step(v, s, p)
    torch.cuda.synchronize()
    _build.reset_launches()
    with math.SolveTape() as tape:
        t0 = time.perf_counter()
        for _ in range(steps):
            v, s, p = step(v, s, p)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES, steps=steps)
    iters = [info.iterations for info in tape]
    ms = elapsed / steps * 1e3
    print(f'{tag} {N}^3: {ms:.2f} ms/step, {N ** 3 / (ms * 1e-3) / 1e6:.1f} Mcells/s over {steps} steps after '
          f'{warmup} warm-up steps; CG iterations per step {iters}')
    print(f'{tag} launches per step: ' + ', '.join(f'{k}={launches.get(k, 0) / steps:g}' for k in KERNELS))
    missing = [k for k in PHASES_3D_KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise RuntimeError(f'{tag}: kernels not launched on the path: {missing}')
    wrong = {}
    if launches.get('window_interp_3d', 0) != K6_LAUNCHES_PER_PHASE_STEP * steps:
        wrong['window_interp_3d'] = (launches.get('window_interp_3d', 0), K6_LAUNCHES_PER_PHASE_STEP * steps)
    cycles, phase_cycles = sum(1 + it for it in iters), sum(1 + it for it in phase_iters)
    for k in ('poisson_stencil', 'jacobi_sweeps', 'residual_restrict', 'prolong_add'):
        if launches.get(k, 0) * phase_cycles != phase_launches.get(k, 0) * cycles:
            wrong[k] = (launches.get(k, 0), f'{phase_launches.get(k, 0)} x {cycles}/{phase_cycles}')
    if wrong:
        raise RuntimeError(f'{tag}: launches on the path (counted, expected): {wrong}')
    div = float(divergence(v).values.torch().abs().max())
    disp = float(advect.max_displacement_cells(s, v, model.dt))
    vel, smoke, pressure = model.state_natives(v, s, p)
    finite = all(bool(torch.isfinite(t).all()) for t in (*vel, smoke, pressure))
    print(f'{tag} max |div| after projection {div:.3e}; max |displacement| {disp:.3f} cells '
          f'(advect.max_displacement_cells; <= max_cells={model.max_cells}: {disp <= model.max_cells}); '
          f'all finite: {finite}; max smoke {float(smoke.max()):.4f}')
    comps, cells = model._shapes()
    shapes_ok = [tuple(t.shape) for t in vel] == comps and tuple(smoke.shape) == cells == tuple(pressure.shape)
    if not (finite and shapes_ok and disp <= model.max_cells and div < 0.1):
        raise RuntimeError(f'{tag} output wrong: finite={finite} shapes_ok={shapes_ok} disp={disp} div={div}')
    return launches


def field_against_array(N, state, steps=2):
    """4-field against the array layer's phases on the card from one 256³
    state: 2 steps each, velocity, smoke and pressure within 1e-5 of each
    field's max |·| with equal CG counts; then the host-clock ms/step of
    both, alternating in one process."""
    from phiflow_tpu_torch.models import SmokePlume
    model = SmokePlume(resolution=N, dims=3, cg_tol=1e-3, max_iterations=100, device='cuda')
    field_step, _ = _stepper(model, True)
    array_step, _ = _stepper(model, True, native=True)
    field_against_native(f'per-phase-field {N}^3', model, field_step, array_step, state, steps, rel_tol=1e-5)
    alternating_host_ms(f'per-phase-field {N}^3', field_step, state, array_step, model.state_natives(*state))


def field_cpu_vs_card(tag, dims, N, steps=2, tol=1e-3):
    """The Field phase methods from one numpy state on the CPU (the twins)
    and on the card (K6 and K1–K4 in 3D, K7 in 2D), compared at `tol` abs."""
    import numpy as np
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.models import SmokePlume, state_from_numpy
    arrays = smooth_state(N, dims)
    out = {}
    for dev in ('cpu', 'cuda'):
        with math.default_device(dev):
            model = SmokePlume(resolution=N, dims=dims, cg_tol=1e-3, max_iterations=100, device=dev)
            v, s, p = model.state_fields(*state_from_numpy(*arrays, device=dev))
            step, _ = _stepper(model, True)
            for _ in range(steps):
                v, s, p = step(v, s, p)
            vel, smoke, _ = model.state_natives(v, s, p)
            out[dev] = [t.cpu().numpy() for t in (*vel, smoke)]
    names = [f'v{"xyz"[d]}' for d in range(dims)] + ['smoke']
    errs = {n: float(np.abs(a - b).max()) for n, a, b in zip(names, out['cpu'], out['cuda'])}
    worst = max(errs.values())
    print(f'cpu vs card through the Field API, {tag} {N}^{dims}, {steps} steps from one numpy state: '
          + ', '.join(f'{n} {e:.2e}' for n, e in errs.items())
          + f'; max {worst:.2e} tol {tol:.0e} {"ok" if worst <= tol else "FAIL"}')
    if not worst <= tol:
        raise RuntimeError(f'CPU and card disagree through the Field API ({tag}): {errs}')


def field_obstacle_against_array(N=48, tol=1e-4):
    """`fluid.make_incompressible(v, [Obstacle(Sphere(...))], Solve(...))` on
    Fields at N³ against `make_incompressible_native` on the same tensors, on
    the card (K1m in its coefficient form): the velocity within `tol`, the CG
    counts at most 1 apart."""
    import torch
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.field import StaggeredGrid
    from phiflow_tpu_torch.geom import Box, Sphere
    from phiflow_tpu_torch.ops import _build
    from phiflow_tpu_torch.physics import fluid
    from phiflow_tpu_torch.physics.fluid import Obstacle
    vel = obstacle_state(N, 'cuda')[0]
    obstacle = Obstacle(Sphere(x=0.5 * N, y=0.45 * N, z=0.55 * N, radius=N / 6), velocity=math.vec(x=0.5, y=0., z=-0.25))
    v = StaggeredGrid(math.stack([math.wrap(c, math.spatial('x,y,z')) for c in vel], math.dual(vector='x,y,z')), 0.,
                      bounds=Box(x=N, y=N, z=N), x=N, y=N, z=N)
    _build.reset_launches()
    with math.SolveTape() as tape:
        v2, p2 = fluid.make_incompressible(v, [obstacle], math.Solve('CG', 1e-4, 0., max_iterations=500,
                                                                     suppress=(math.ConvergenceException,)))
    k1m = _build.LAUNCHES.get('poisson_stencil_coeffs', 0)
    ref_v, ref_p, result = fluid.make_incompressible_native(vel, None, 1.0, rel_tol=1e-4, abs_tol=0.,
                                                            max_iterations=500, obstacles=[obstacle])
    from phiflow_tpu_torch.field._field import face_components
    got_v = [c.native(('x', 'y', 'z')) for c in face_components(v2.values)]
    errs = {f'v{a}': float((g - r).abs().max()) for a, g, r in zip('xyz', got_v, ref_v)}
    errs['pressure'] = float((p2.values.native(('x', 'y', 'z')) - ref_p).abs().max())
    apart = abs(tape[0].iterations - result.iterations)
    ok = max(errs[f'v{a}'] for a in 'xyz') <= tol and apart <= 1 and k1m > 0
    print(f'field vs array on the card, make_incompressible with an Obstacle(Sphere) at {N}^3: '
          + ', '.join(f'{n} {e:.2e}' for n, e in errs.items())
          + f'; CG iterations field {tape[0].iterations} array {result.iterations}; K1m (coefficient form) launches '
            f'{k1m}; velocity tol {tol:.0e}: ' + ('ok' if ok else 'FAIL'))
    if not ok:
        raise RuntimeError(f'Field and array obstacle projections disagree: {errs}, CG {tape[0].iterations} vs '
                           f'{result.iterations}, K1m launches {k1m}')


def profile_field(tag, N, state):
    """torch.profiler over 3 steps of path 4-field (compare with the native
    phases' profile)."""
    from phiflow_tpu_torch.models import SmokePlume
    model = SmokePlume(resolution=N, dims=3, cg_tol=1e-3, max_iterations=100, device='cuda')
    step, _ = _stepper(model, True)
    native_step, _ = _stepper(model, True, native=True)
    profile_path(tag, f'{N}^3', lambda st: step(*st), state, rows_shown=16)
    profile_path(f'{tag} native', f'{N}^3', lambda st: native_step(*st), model.state_natives(*state), rows_shown=8)


# ---------------------------------------------------------------------------
# the obstacle path: make_incompressible(velocity, obstacles) in 3D
# ---------------------------------------------------------------------------

def obstacle_setup(N):
    """The three obstacles of the obstacle path in a closed box of N³ unit
    cells, apart from each other by more than a cell: a stationary sphere, a
    translating cuboid, a translating and spinning sphere."""
    from phiflow_tpu_torch.geom import Cuboid, Sphere
    from phiflow_tpu_torch.physics.fluid import Obstacle
    return (Obstacle(Sphere((0.5 * N, 0.5 * N, 0.3 * N), N / 8)),
            Obstacle(Cuboid((0.25 * N, 0.7 * N, 0.62 * N), (N / 16, N / 10, N / 12)), velocity=(1.0, 0.0, 0.5)),
            Obstacle(Sphere((0.74 * N, 0.3 * N, 0.72 * N), N / 10), velocity=(-0.5, 1.0, 0.0),
                     angular_velocity=(0.0, 0.02, 0.05)))


def obstacle_stepper(N, dt=OBSTACLE_DT, cg_tol=1e-4, max_iterations=500, preconditioner='chebyshev', method='CG'):
    """The body of `MovingObstacles.step` in 3D in the closed box, written
    with the port's public functions; the projection solves by `method` with
    `fluid.MASKED_PRECONDITIONER` set to `preconditioner`. Returns
    step(v, p, *obstacles) -> ((v, p, *obstacles), solve result) and its
    three phases."""
    import numpy as np
    from phiflow_tpu_torch.physics import advect, fluid
    size = np.full(3, N, np.float32)

    def move(obstacles):
        return tuple(o.at((o.geometry.center + o.velocity * np.float32(dt)) % size) for o in obstacles)

    def advect_velocity(v):
        return advect.mac_cormack_native(v, v, dt, 1.0, 0.0)

    def project(v, p, obstacles):
        default = fluid.MASKED_PRECONDITIONER
        fluid.MASKED_PRECONDITIONER = preconditioner
        try:
            return fluid.make_incompressible_native(v, p, 1.0, rel_tol=cg_tol, abs_tol=0., max_iterations=max_iterations,
                                                    obstacles=obstacles, method=method)
        finally:
            fluid.MASKED_PRECONDITIONER = default

    def step(v, p, *obstacles):
        obstacles = move(obstacles)
        v, p, result = project(advect_velocity(v), p, obstacles)
        return (v, p) + obstacles, result

    return step, move, advect_velocity, project


def obstacle_masks(N):
    """The obstacle path's staged coefficient arrays and accessible cells at
    N³ on the card, as `make_incompressible` stages them for its solve."""
    import torch
    from phiflow_tpu_torch.field import cell_grid, geometry_mask, stagger_native
    from phiflow_tpu_torch.geom import union
    from phiflow_tpu_torch.ops import poisson as P
    from phiflow_tpu_torch.physics import fluid
    accessible = geometry_mask(~union([o.geometry for o in obstacle_setup(N)]),
                               cell_grid((N,) * 3, 1.0, 'cuda')).contiguous()
    mA, c0 = P.stage_masks(fluid._full_face_masks(stagger_native(accessible, torch.minimum, 0.0)), PATH_BC, (1.0,) * 3)
    return mA, c0, accessible


def obstacle_state(N, dev, seeds=None):
    """The obstacle path's state: the velocity and pressure of `smooth_state(N)`, or with `seeds` one entry a seed
    along a leading batch axis (a sweep over one geometry), and the three obstacles, shared."""
    import numpy as np
    import torch
    if seeds is None:
        *vel, _, pressure = smooth_state(N, 3)
    else:
        *vel, _, pressure = (np.stack(parts) for parts in zip(*[smooth_state(N, 3, seed=s) for s in seeds]))
    return (tuple(torch.from_numpy(c).to(dev) for c in vel), torch.from_numpy(pressure).to(dev)) + obstacle_setup(N)


V_CYCLE_KERNELS = ('jacobi_sweeps', 'residual_restrict', 'prolong_add')


def smoothed_levels(N):
    """The V-cycle's levels with smoothing at N³ under math/_multigrid.py's
    defaults (halving down to 4 cells, a direct solve up to 512 unknowns):
    every level but a coarsest one solved directly."""
    levels, n = 1, N
    while n % 2 == 0 and n > 4:
        n //= 2
        levels += 1
    return levels - 1 if n ** 3 <= 512 else levels
# max |div·active − its mean| after an obstacle projection at 256³, cg_tol 1e-4, by preconditioner: about ten times
# what each read on an H100 (1.277e-05 in three runs under 'chebyshev', 8.237e-05 under 'vcycle')
OBSTACLE_DIV_BOUND = {'chebyshev': 2e-4, 'vcycle': 8e-4}


def run_obstacles(tag, N, warmup=2, steps=5, preconditioner='chebyshev', method='CG'):
    """The obstacle step at N³ on the card under one of the masked systems'
    preconditioners, its projection solved by `method` ('CG' or
    'CG-adaptive'): launch counts of a timed run, the split, and the gates
    on what comes out."""
    import torch
    from phiflow_tpu_torch.field import cell_grid, divergence_native, geometry_mask, spatial_gradient_native, stagger_native
    from phiflow_tpu_torch.geom import union
    from phiflow_tpu_torch.ops import _build
    from phiflow_tpu_torch.physics import fluid
    step, move, advect_velocity, project = obstacle_stepper(N, preconditioner=preconditioner, method=method)
    state = obstacle_state(N, 'cuda')
    for _ in range(warmup):
        state, _ = step(*state)
    torch.cuda.synchronize()
    _build.reset_launches()
    solves = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, result = step(*state)
        solves.append(result)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES, steps=steps)
    ms = elapsed / steps * 1e3
    iters = [r.iterations for r in solves]
    print(f'{tag} {N}^3: {ms:.2f} ms/step, {N ** 3 / (ms * 1e-3) / 1e6:.1f} Mcells/s over {steps} steps after '
          f'{warmup} warm-up steps; CG iterations per step {iters}, converged {[r.converged for r in solves]} '
          f'(cg_tol 1e-4, at most 500, MASKED_PRECONDITIONER {preconditioner!r}, method {method!r})')
    print(f'{tag} launches per step: ' + ', '.join(f'{k}={launches.get(k, 0) / steps:g}' for k in KERNELS))
    if preconditioner == 'chebyshev':
        # K1m: two diagonal probes, A·x0 and the first preconditioner's three a solve (CG-adaptive: and A·d0), four
        # an iteration — all of them with the coefficient arrays and the accessible cells
        k1m = sum((7 if method == 'CG-adaptive' else 6) + 4 * it for it in iters)
        v_cycles = 0
    else:
        # the projected V-cycle: A·x0 and one matvec an iteration through K1m; one V-cycle (K2–K4, no K1) a solve
        # and one an iteration
        k1m = v_cycles = sum(1 + it for it in iters)
    expected = {'poisson_stencil_coeffs': k1m, 'poisson_stencil_masked': k1m, 'poisson_stencil': k1m,
                'window_interp_3d': K6_LAUNCHES_PER_OBSTACLE_STEP * steps}
    if v_cycles:
        expected['jacobi_sweeps'] = K2_LAUNCHES_PER_LEVEL * smoothed_levels(N) * v_cycles
    wrong = {k: (launches.get(k, 0), e) for k, e in expected.items() if launches.get(k, 0) != e or e == 0}
    # K3, K4 (K2 under Chebyshev): the same whole number of launches in every V-cycle, none without one
    for k in V_CYCLE_KERNELS:
        if k in expected:
            continue
        count = launches.get(k, 0)
        if (count == 0 or count % v_cycles) if v_cycles else count:
            wrong[k] = (count, f'a positive multiple of {v_cycles} V-cycles' if v_cycles else 0)
    if wrong:
        raise RuntimeError(f'{tag}: launches on the path (counted, expected): {wrong}')
    if v_cycles:
        print(f'{tag}: {v_cycles} V-cycles in {steps} steps, launches a V-cycle: '
              + ', '.join(f'{k}={launches[k] // v_cycles}' for k in V_CYCLE_KERNELS))
    # the split, from 3 more steps timed phase by phase; the masks and boundary conditions and the gradient are
    # the projection's own first and last part, run once more on their own to be timed
    split = {'masks + boundary conditions': [], 'advection': [], 'projection': [], 'gradient': []}
    v, p, *obstacles = state
    cells = cell_grid((N,) * 3, 1.0, 'cuda')
    for _ in range(3):
        obstacles = move(obstacles)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        accessible = geometry_mask(~union([o.geometry for o in obstacles]), cells).contiguous()
        hard_bcs = stagger_native(accessible, torch.minimum, 0.0)
        fluid.apply_boundary_conditions_native(v, obstacles, 1.0)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        v = advect_velocity(v)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        v, p, result = project(v, p, obstacles)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        tuple(c - g * m for c, g, m in zip(v, spatial_gradient_native(p, 1.0), hard_bcs))
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for key, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            split[key].append(dt * 1e3)
        solves.append(result)
    med = {k: statistics.median(x) for k, x in split.items()}
    print(f'{tag} split: advection {med["advection"]:.2f} ms, projection {med["projection"]:.2f} ms, of which masks + '
          f'boundary conditions {med["masks + boundary conditions"]:.2f} ms, gradient {med["gradient"]:.2f} ms and '
          f'the solve the rest, {med["projection"] - med["masks + boundary conditions"] - med["gradient"]:.2f} ms '
          f'({solves[-1].iterations} iterations in the last; median of 3 steps timed phase by phase)')
    # gates on the final state
    blocked = int((accessible == 0).sum())
    div = divergence_native(v, 1.0) * accessible
    balance = float(div.sum() / accessible.sum())
    div_dev = float(((div - balance) * accessible).abs().max())
    finite = all(bool(torch.isfinite(t).all()) for t in (*v, p))
    sphere, cuboid = obstacles[0], obstacles[1]
    inside_err = 0.0
    for geometry, imposed in ((sphere.geometry, sphere.velocity), (cuboid.geometry, cuboid.velocity)):
        # a face is fully inside where both its cells' centres are
        faces = stagger_native(geometry_mask(geometry, cells), torch.minimum, 0.0)
        for comp, m, u in zip(v, faces, imposed):
            if int(m.sum()) == 0:
                raise RuntimeError(f'{tag}: no face inside {geometry!r}')
            inside_err = max(inside_err, float(((comp - float(u)) * m).abs().max()))
    print(f'{tag} blocked cells {blocked} of {N ** 3} ({100 * blocked / N ** 3:.2f}%); after projection max |div·active − '
          f'its mean {balance:.3e}| {div_dev:.3e} (bound {OBSTACLE_DIV_BOUND[preconditioner]:.0e}); faces inside the stationary sphere and the translating '
          f'cuboid off their imposed velocity by at most {inside_err:.3e} (tol 1e-6); all finite: {finite}; '
          f'max |v| {max(float(c.abs().max()) for c in v):.3f}')
    shapes_ok = [tuple(c.shape) for c in v] == [tuple(N - (a == d) for a in range(3)) for d in range(3)]
    if not (finite and shapes_ok and 0 < blocked < N ** 3 and div_dev < OBSTACLE_DIV_BOUND[preconditioner] and inside_err <= 1e-6):
        raise RuntimeError(f'{tag} output wrong: finite={finite} shapes_ok={shapes_ok} blocked={blocked} '
                           f'div_dev={div_dev} inside_err={inside_err}')
    return launches


def obstacles_cpu_vs_card(N=48, steps=2, tol=1e-4, preconditioner='chebyshev'):
    """The obstacle step from one numpy state on the CPU (the twins) and on
    the card (K6, K1m; K2–K4 under 'vcycle'). The velocity within `tol` (the
    Chebyshev run read 2.15e-06 on an H100; the solves stop at cg_tol 1e-4 of
    a right-hand side of order 1) and the CG counts within 1 of each other."""
    import numpy as np
    out = {}
    for dev in ('cpu', 'cuda'):
        step = obstacle_stepper(N, preconditioner=preconditioner)[0]
        state = obstacle_state(N, dev)
        iters = []
        for _ in range(steps):
            state, result = step(*state)
            iters.append(result.iterations)
        out[dev] = [c.cpu().numpy() for c in state[0]] + [state[1].cpu().numpy(), iters]
    names = ('vx', 'vy', 'vz', 'pressure')
    errs = {n: float(np.abs(a - b).max()) for n, a, b in zip(names, out['cpu'], out['cuda'])}
    worst = max(errs[n] for n in names[:3])
    iters_apart = max(abs(a - b) for a, b in zip(out['cpu'][4], out['cuda'][4]))
    ok = worst <= tol and iters_apart <= 1
    print(f'cpu vs card, obstacles {N}^3 under {preconditioner!r}, {steps} steps from one numpy state: '
          + ', '.join(f'{n} {e:.2e}' for n, e in errs.items())
          + f'; CG iterations cpu {out["cpu"][4]} card {out["cuda"][4]} (at most 1 apart); velocity tol {tol:.0e} '
          + ('ok' if ok else 'FAIL'))
    if not ok:
        raise RuntimeError(f'CPU and card disagree (obstacles, {preconditioner}): {errs}, CG iterations '
                           f'{out["cpu"][4]} and {out["cuda"][4]}')


def run_model_2d(tag, model, warmup=2, steps=5):
    """A 2D obstacle model on the card: its Field `step` from rest, then
    against `step_native` (bit-equal). The advection goes through K7; the
    masked stencil is PyTorch operations."""
    import torch
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.ops import _build
    state = model.initial_state()
    for _ in range(warmup):
        state = model.step(*state)
    torch.cuda.synchronize()
    _build.reset_launches()
    with math.SolveTape() as tape:
        t0 = time.perf_counter()
        for _ in range(steps):
            state = model.step(*state)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3
    launches = dict(_build.LAUNCHES)
    v, p = model.state_natives(*state)[:2]
    finite = all(bool(torch.isfinite(t).all()) for t in (*v, p))
    print(f'{tag} {model.resolution}^2: {ms:.2f} ms/step over {steps} Field steps after {warmup} warm-up steps; CG '
          f'iterations per step {[info.iterations for info in tape]}, converged {[info.converged for info in tape]}; '
          f'launches per step: window_interp_2d={launches.get("window_interp_2d", 0) / steps:g}; max |v| '
          f'{max(float(c.abs().max()) for c in v):.3f}; all finite: {finite}')
    if launches.get('window_interp_2d', 0) == 0 or not finite or max(float(c.abs().max()) for c in v) == 0:
        raise RuntimeError(f'{tag}: window_interp_2d launched {launches.get("window_interp_2d", 0)} times, finite={finite}')
    field_against_native(tag, model, model.step, model.step_native, state)
    return launches


# ---------------------------------------------------------------------------
# the 2D grid models: Burgers (K7, wrap, K = 2) and KolmogorovFlow (no kernel of ours)
# ---------------------------------------------------------------------------

BURGERS_N = 128          # bench.py's Burgers(128, implicit=True)
BURGERS_K7_PER_STEP = 2  # the window of each velocity component, halo 'wrap', K = 2
KOLMOGOROV_N = 512       # bench.py's KolmogorovFlow(512, order=6, dt=0.002), float32 and float64
KOLMOGOROV_DT = 0.002


def check_burgers_k7(ch, model):
    """K7 on the Burgers path's own first-step inputs: each velocity
    component at its displacement (−dt·v)/dx, halo 'wrap', K = 2 (the clamp
    reached all over the grid), against its twin at check_interp's value
    tolerance; then timed there. These launches are comparisons: the path's
    count starts from 0 after them."""
    import torch
    from phiflow_tpu_torch.ops import interp as I
    (v,) = model.initial_state()
    comps = [c.contiguous() for c in model.state_natives(v)]
    disps = [(-model.dt * c) / h for c, h in zip(comps, model._dx)]
    cells = max(float(d.abs().max()) for d in disps)
    clamped = float(sum((d.abs() > 2).float().mean() for d in disps)) / len(disps)
    for a, c in enumerate(comps):
        got = I.window_interp_2d(c, disps, 2, halo='wrap')
        ref = I._window_interp_plain(c, disps, 2, False, (1.0, 1.0), 'wrap', 0.0)
        case = f'Burgers {model.resolution}^2 first step, v_{"xy"[a]}: wrap K=2'
        ch.compare('window_interp_2d', case, got, ref, 1e-5)
    print(f'note  window_interp_2d Burgers {model.resolution}^2 first step: max |displacement| {cells:.2f} cells, '
          f'{clamped:.1%} of the taps clamped to +-2')
    c = comps[0]
    ops = (2 ** 2 * 3 + 8 * 2) * c.numel()
    ch.time('window_interp_2d', f'Burgers velocity component: wrap halo, {tuple(c.shape)} K=2',
            lambda: I.window_interp_2d(c, disps, 2, halo='wrap'),
            lambda: I._window_interp_plain(c, disps, 2, False, (1.0, 1.0), 'wrap', 0.0),
            nbytes(c, *disps) + nbytes(c), ops, key='window_interp_2d burgers')
    ch.attach('window_interp_2d', ['window_interp_2d burgers'])


def run_burgers(tag, implicit, warmup=2, steps=5):
    """Burgers(128) on the card through its Field `step`: ms a step, CG
    iterations a step, K7 exactly 2 launches a step and no other kernel of
    ours, finite values."""
    import torch
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.models import Burgers
    from phiflow_tpu_torch.ops import _build
    model = Burgers(BURGERS_N, implicit=implicit, device='cuda')
    (v,) = model.initial_state()
    for _ in range(warmup):
        (v,) = model.step(v)
    torch.cuda.synchronize()
    _build.reset_launches()
    with math.SolveTape() as tape:
        t0 = time.perf_counter()
        for _ in range(steps):
            (v,) = model.step(v)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3
    launches = dict(_build.LAUNCHES, steps=steps)
    comps = model.state_natives(v)
    finite = all(bool(torch.isfinite(c).all()) for c in comps)
    v_max = max(float(c.abs().max()) for c in comps)
    others = {k: n for k, n in launches.items() if k not in ('window_interp_2d', 'steps') and n}
    print(f'{tag} {BURGERS_N}^2: {ms:.2f} ms/step over {steps} Field steps after {warmup} warm-up steps; CG '
          f'iterations per step {[info.iterations for info in tape]}, converged {[info.converged for info in tape]}; '
          f'launches per step: window_interp_2d={launches.get("window_interp_2d", 0) / steps:g} (expected '
          f'{BURGERS_K7_PER_STEP}), others {others}; max |v| {v_max:.3f}; all finite: {finite}')
    if launches.get('window_interp_2d', 0) != BURGERS_K7_PER_STEP * steps or others or not finite or v_max == 0:
        raise RuntimeError(f'{tag}: window_interp_2d launched {launches.get("window_interp_2d", 0)} times in {steps} '
                           f'steps, others {others}, finite={finite}')
    return launches


def run_kolmogorov(tag, bits, warmup=1, steps=3):
    """KolmogorovFlow(512, order=6, dt=0.002) on the card through its Field
    `step`, its values of `bits` (`math.set_global_precision`): ms a step,
    CG iterations a solve, max |divergence| (order 6) after the last step, no
    kernel of ours launched, finite values. Float32 products without TF32."""
    import torch
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.field import divergence
    from phiflow_tpu_torch.models import KolmogorovFlow
    from phiflow_tpu_torch.ops import _build
    if torch.backends.cuda.matmul.allow_tf32 is not False or torch.get_float32_matmul_precision() != 'highest':
        raise RuntimeError('TF32 is on for float32 matrix products: the order-6 operators need full float32')
    math.set_global_precision(bits)
    try:
        model = KolmogorovFlow(KOLMOGOROV_N, order=6, dt=KOLMOGOROV_DT, device='cuda')
        v, p = model.initial_state()
        for _ in range(warmup):
            v, p = model.step(v, p)
        torch.cuda.synchronize()
        _build.reset_launches()
        with math.SolveTape() as tape:
            t0 = time.perf_counter()
            for _ in range(steps):
                v, p = model.step(v, p)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / steps * 1e3
        launches = {k: n for k, n in _build.LAUNCHES.items() if n}
        comps, pressure = model.state_natives(v, p)
        div = float(divergence(v, order=6).values.native(('x', 'y')).abs().max())
    finally:
        math.set_global_precision(32)
    finite = all(bool(torch.isfinite(t).all()) for t in (*comps, pressure))
    print(f'{tag} {KOLMOGOROV_N}^2 order 6 float{bits} ({comps[0].dtype}): {ms:.2f} ms/step over {steps} Field steps '
          f'after {warmup} warm-up step(s); CG iterations per solve {[info.iterations for info in tape]}, converged '
          f'{[info.converged for info in tape]}; max |div| (order 6) {div:.3e}; max |v| '
          f'{max(float(c.abs().max()) for c in comps):.3f}; kernels of ours launched: {launches or "none"}; '
          f'all finite: {finite}')
    if launches or not finite or comps[0].dtype != (torch.float64 if bits == 64 else torch.float32):
        raise RuntimeError(f'{tag}: launches {launches}, finite={finite}, dtype {comps[0].dtype}')
    return dict(steps=steps)


def grid_models_cpu_vs_card(steps=2):
    """Burgers 128² (both diffusions; 1e-3 abs) and Kolmogorov 64² order 6
    (1e-4 of the field's scale, CG counts at most 1 apart, each step whose
    solves all converged): `steps` Field steps from one numpy state on the
    CPU and on the card."""
    import numpy as np
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.models import Burgers, KolmogorovFlow
    from phiflow_tpu_torch.models import burgers as burgers_mod, kolmogorov as kolmogorov_mod
    for implicit in (False, True):
        init = burgers_mod.state_to_numpy(Burgers(BURGERS_N, implicit=implicit, device='cpu').initial_state_native())
        out = {}
        for dev in ('cpu', 'cuda'):
            model = Burgers(BURGERS_N, implicit=implicit, device=dev)
            with math.default_device(dev), math.SolveTape() as tape:
                (v,) = model.state_fields(burgers_mod.state_from_numpy(init, device=dev))
                for _ in range(steps):
                    (v,) = model.step(v)
            out[dev] = burgers_mod.state_to_numpy(model.state_natives(v)), [info.iterations for info in tape]
        err = max(float(np.abs(a - b).max()) for a, b in zip(out['cpu'][0], out['cuda'][0]))
        scale = max(float(np.abs(a).max()) for a in out['cpu'][0])
        apart = max([abs(a - b) for a, b in zip(out['cpu'][1], out['cuda'][1])] or [0])
        ok = err <= 1e-3 and apart <= 1
        print(f'cpu vs card, Burgers {BURGERS_N}^2 implicit={implicit}, {steps} Field steps from one numpy state: '
              f'max |diff| {err:.2e} (field scale {scale:.2f}, {err / scale:.2e} of it); CG iterations cpu '
              f'{out["cpu"][1]} card {out["cuda"][1]}; tol 1e-03 abs {"ok" if ok else "FAIL"}')
        if not ok:
            raise RuntimeError(f'CPU and card disagree (Burgers implicit={implicit}): {err}')
    # the wide stencil's float32 solves may stall above cg_tol (both packages: roundoff in the null-space modes
    # the mean removal leaves, ROADMAP.md §3), and an unconverged solve ends anywhere: a step is compared while
    # every solve up to it converged on both sides
    n = 64
    init = kolmogorov_mod.state_to_numpy(KolmogorovFlow(n, order=6, device='cpu').initial_state_native())
    out = {}
    for dev in ('cpu', 'cuda'):
        model = KolmogorovFlow(n, order=6, dt=KOLMOGOROV_DT, device=dev)
        out[dev] = []
        with math.default_device(dev):
            v, p = model.state_fields(*kolmogorov_mod.state_from_numpy(*init, device=dev))
            for _ in range(steps):
                with math.SolveTape() as tape:
                    v, p = model.step(v, p)
                out[dev].append((kolmogorov_mod.state_to_numpy(model.state_natives(v, p)),
                                 [info.iterations for info in tape], all(info.converged for info in tape)))
    compared = 0
    for k, ((cpu_state, cpu_it, cpu_ok), (card_state, card_it, card_ok)) in enumerate(zip(out['cpu'], out['cuda'])):
        if not (cpu_ok and card_ok):
            print(f'cpu vs card, Kolmogorov {n}^2 order 6, step {k + 1}: a solve stopped unconverged at '
                  f'max_iterations (CG iterations cpu {cpu_it} card {card_it}); not compared from here on')
            break
        (vc, pc), (vg, pg) = cpu_state, card_state
        rel = {name: float(np.abs(a - b).max()) / max(float(np.abs(a).max()), 1e-30)
               for name, a, b in (('vx', vc[0], vg[0]), ('vy', vc[1], vg[1]), ('pressure', pc, pg))}
        apart = max(abs(a - b) for a, b in zip(cpu_it, card_it))
        ok = max(rel.values()) <= 1e-4 and apart <= 1
        print(f'cpu vs card, Kolmogorov {n}^2 order 6, step {k + 1} from one numpy state: max |diff| / field scale '
              + ', '.join(f'{name} {e:.2e}' for name, e in rel.items())
              + f'; CG iterations cpu {cpu_it} card {card_it} (at most 1 apart); tol 1e-04 ' + ('ok' if ok else 'FAIL'))
        if not ok:
            raise RuntimeError(f'CPU and card disagree (Kolmogorov step {k + 1}): {rel}, CG iterations {cpu_it} and '
                               f'{card_it}')
        compared += 1
    if not compared:
        raise RuntimeError('Kolmogorov CPU vs card: no step whose solves all converged')


def run_grid_models(ch):
    """The "2D grid models" phase: K7 on Burgers' own inputs, the two
    Burgers configurations, Kolmogorov in float32 and float64, then CPU
    against the card. Returns the launch counts by path."""
    from phiflow_tpu_torch.models import Burgers
    t0 = time.perf_counter()
    check_burgers_k7(ch, Burgers(BURGERS_N, implicit=True, device='cuda'))
    by_path = {'burgers-implicit': run_burgers('burgers-implicit', True),
               'burgers-explicit': run_burgers('burgers-explicit', False),
               'kolmogorov-f32': run_kolmogorov('kolmogorov-f32', 32),
               'kolmogorov-f64': run_kolmogorov('kolmogorov-f64', 64, steps=2)}
    grid_models_cpu_vs_card()
    print(f'2D grid models: {time.perf_counter() - t0:.1f} s')
    if ch.failed:
        raise RuntimeError(f'kernel checks failed: {ch.failed}')
    return by_path


def profile_grid_models():
    """Burgers(128, implicit=True)'s Field step, and KolmogorovFlow(512,
    order=6)'s float32 Field step beside its `step_native`."""
    from phiflow_tpu_torch.models import Burgers, KolmogorovFlow
    model = Burgers(BURGERS_N, implicit=True, device='cuda')
    profile_path('burgers-implicit', f'{BURGERS_N}^2', lambda state: model.step(*state), model.initial_state(),
                 rows_shown=8)
    model = KolmogorovFlow(KOLMOGOROV_N, order=6, dt=KOLMOGOROV_DT, device='cuda')
    profile_path('kolmogorov-f32', f'{KOLMOGOROV_N}^2', lambda state: model.step(*state), model.initial_state(),
                 warmup=1, steps=2, rows_shown=8)
    profile_path('kolmogorov-f32 native', f'{KOLMOGOROV_N}^2', lambda state: model.step_native(*state),
                 model.initial_state_native(), warmup=1, steps=2, rows_shown=8)


# ---------------------------------------------------------------------------
# SPH: the dam break (the cell list and the edge arithmetic are PyTorch operations; no kernel of ours)
# ---------------------------------------------------------------------------

SPH_SIZES = {  # tag → SphDamBreak's arguments
    'sph-dam': {},  # the model's own configuration: 10,000 particles, M = 189, 3688 dropped at step 0
    # 1,280,000 particles inside the box: 852² cells, capacity 17, M = 153; dt scaled with dx (the default's Courant number)
    'sph-dam-1.28M': dict(nx=800, ny=1600, dx=0.0005, dt=1.25e-5),
}
SPH_DROPPED_DEFAULT = 3688  # the same particles in the JAX package (tests/test_torch_sph_neighbors.py)


def sph_search(model, particles):
    """(indices, mask) of the model's cell-list search on the particles'
    positions, run with every device→host sync an error."""
    import torch
    from phiflow_tpu_torch.math._neighbors import cell_list_neighbors
    pos = particles.geometry.center.native(('points', 'vector'))
    torch.cuda.set_sync_debug_mode('error')
    try:
        idx, _, mask = cell_list_neighbors(pos, model.support, [0., 0.], [1., 1.])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return idx, mask


def sph_neighbours(idx, mask):
    """(particles dropped from the buckets, mean neighbours a particle): a
    particle's own cell is always among its candidate cells."""
    import torch
    own = (idx == torch.arange(idx.shape[0], device=idx.device, dtype=idx.dtype)[:, None]).any(1)
    return int(idx.shape[0] - int(own.sum())), float(mask.sum()) / idx.shape[0]


def syncs_a_step(step, state):
    """The synchronizing CUDA operations (device→host reads, blocking copies)
    that one call of `step(state)` makes, as `set_sync_debug_mode('warn')`
    reports them: (their count, the source lines that made them, the new
    state)."""
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            state = step(state)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    # the mode's own switch can report one: not the step's
    syncs = [w for w in caught if 'synchronizing' in str(w.message) and not w.filename.endswith('cuda/__init__.py')]
    return len(syncs), sorted({f'{w.filename.split("/")[-1]}:{w.lineno}' for w in syncs}), state


def run_sph(tag, warmup, steps):
    """SphDamBreak on the card through its Field `step`: ms a step, M
    particles/s, the particles dropped from the buckets at step 0 and the
    mean neighbours (the cell list run with syncs an error), the syncs a
    step, the peak device memory of the timed steps, no kernel of ours
    launched, the state finite and inside [−0.02, 1.02]."""
    import torch
    from phiflow_tpu_torch.models import SphDamBreak
    from phiflow_tpu_torch.ops import _build
    model = SphDamBreak(**SPH_SIZES[tag], device='cuda')
    (p,) = model.initial_state()
    idx, mask = sph_search(model, p)
    dropped, neighbours = sph_neighbours(idx, mask)
    candidates = idx.shape[1]
    del idx, mask
    for _ in range(warmup):
        (p,) = model.step(p)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        (p,) = model.step(p)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    launches = {k: n for k, n in _build.LAUNCHES.items() if n}
    peak = torch.cuda.max_memory_allocated()
    syncs, sync_lines, (p,) = syncs_a_step(lambda state: model.step(*state), (p,))
    pos = p.geometry.center.native(('points', 'vector'))
    vel = p.values.native(('points', 'vector'))
    finite = bool(torch.isfinite(pos).all()) and bool(torch.isfinite(vel).all())
    lo, hi = float(pos.min()), float(pos.max())
    print(f'{tag} {model.n_particles} particles, M = {candidates} candidates a particle: {ms:.2f} ms/step over {steps} '
          f'Field steps after {warmup} warm-up step(s), {model.n_particles / ms * 1e-3:.2f} M particles/s; step 0: '
          f'{dropped} particles dropped from the buckets, {neighbours:.2f} neighbours a particle; syncs a step '
          f'{syncs} {sync_lines or ""}; max_memory_allocated {peak / 2 ** 30:.2f} GiB; max |v| {float(vel.abs().max()):.4f}; positions '
          f'in [{lo:.4f}, {hi:.4f}]; kernels of ours launched: {launches or "none"}; all finite: {finite}')
    bad = []
    if launches:
        bad.append(f'kernels of ours launched {launches}')
    if not finite or lo < -0.02 or hi > 1.02:
        bad.append(f'finite={finite}, positions in [{lo}, {hi}]')
    if tag == 'sph-dam' and dropped != SPH_DROPPED_DEFAULT:
        bad.append(f'{dropped} particles dropped, {SPH_DROPPED_DEFAULT} expected')
    if tag != 'sph-dam' and (dropped or not 19 <= neighbours <= 21):
        bad.append(f'{dropped} particles dropped (none expected), {neighbours:.2f} neighbours (19-21 expected)')
    if bad:
        raise RuntimeError(f'{tag}: ' + '; '.join(bad))
    return dict(steps=steps)


def sph_cpu_vs_card():
    """The default configuration's initial state: the cell list's indices and
    mask bit-equal on the CPU and the card, and its first Field step within
    2e-6 in positions and 2e-4 in velocities (the model diverges from step 2:
    no later step is compared); SphDamBreak(nx=20, ny=40): 5 steps within
    1e-6 and 2e-4."""
    import numpy as np
    import torch
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.models import SphDamBreak
    for kw, steps, pos_tol in (({}, 1, 2e-6), (dict(nx=20, ny=40), 5, 1e-6)):
        out = {}
        for dev in ('cpu', 'cuda'):
            with math.default_device(dev):
                model = SphDamBreak(**kw, device=dev)
                (p,) = model.initial_state()
                search = [t.cpu().numpy() for t in sph_search(model, p)]
                states = []
                for _ in range(steps):
                    (p,) = model.step(p)
                    states.append([t.native(('points', 'vector')).cpu().numpy() for t in (p.geometry.center, p.values)])
            out[dev] = search, states
        size = f'{model.n_particles} particles'
        equal = all(np.array_equal(a, b) for a, b in zip(out['cpu'][0], out['cuda'][0]))
        print(f'cpu vs card, SphDamBreak({kw}) {size}: cell-list indices and mask of the initial state bit-equal: '
              f'{equal}')
        if not equal:
            raise RuntimeError(f'SPH cell lists differ between the CPU and the card ({kw})')
        for k, ((pc, vc), (pg, vg)) in enumerate(zip(out['cpu'][1], out['cuda'][1])):
            dp, dv = float(np.abs(pc - pg).max()), float(np.abs(vc - vg).max())
            ok = dp <= pos_tol and dv <= 2e-4
            print(f'cpu vs card, SphDamBreak({kw}) step {k + 1}: max |diff| positions {dp:.3e} (tol {pos_tol:g}), '
                  f'velocities {dv:.3e} (tol 2e-4; max |v| {float(np.abs(vc).max()):.4f}) {"ok" if ok else "FAIL"}')
            if not ok:
                raise RuntimeError(f'CPU and card disagree (SphDamBreak({kw}) step {k + 1}): {dp}, {dv}')
        torch.cuda.empty_cache()


def run_sph_models():
    """The "SPH" phase: the default dam break (2 warm-up, 5 timed steps), the
    1.28 M-particle one (1 + 3), then CPU against the card. Returns the
    launch counts by path."""
    import torch
    t0 = time.perf_counter()
    by_path = {'sph-dam': run_sph('sph-dam', warmup=2, steps=5)}
    torch.cuda.empty_cache()
    by_path['sph-dam-1.28M'] = run_sph('sph-dam-1.28M', warmup=1, steps=3)
    torch.cuda.empty_cache()
    sph_cpu_vs_card()
    print(f'SPH: {time.perf_counter() - t0:.1f} s')
    return by_path


def profile_sph():
    """3 Field steps of each SPH size under the profiler."""
    import torch
    from phiflow_tpu_torch.models import SphDamBreak
    for tag, kw in SPH_SIZES.items():
        model = SphDamBreak(**kw, device='cuda')
        profile_path(tag, f'{model.n_particles} particles', lambda state: model.step(*state), model.initial_state(),
                     warmup=1, steps=3, rows_shown=12)
        del model
        torch.cuda.empty_cache()


FVM_SIZES = {
    'cylinder-wake': {},  # the model's own configuration: 400 × 128, 50,892 cells
    # 4× finer per axis, dt scaled with dx (the default's Courant number): 819,200 cells less the cylinder's
    'cylinder-wake-1600x512': dict(nx=1600, ny=512, dt=0.0125),
}
# (warm-up, timed) Field steps. The refined wake's pressure solves stop at their 500 iterations unconverged; its
# third step returns the diverging BiCGStab's last iterate (max |v| in the thousands, then NaN) — the JAX package's
# algorithm, which diverges the same way at 800 × 256 in its first step. So it takes 1 warm-up and 1 timed step.
FVM_RUNS = {'cylinder-wake': (1, 1), 'cylinder-wake-1600x512': (1, 1)}
# the JAX suite's configuration (tests/physics/test_cylinder_wake.py) at a tolerance tight enough to compare
FVM_SUITE = dict(nx=120, ny=36, re=120., dt=0.08, diameter=0.5, upwind=False, perturb=0.2, solve_tol=1e-5,
                 max_iterations=300)
FVM_V_MAX = 3.0  # |v| bound of the JAX suite's wake test (U∞ = 1)
FVM_TABLES = ('center', 'volume', 'neighbors', 'face_areas', 'face_centers', 'face_normals', 'neighbor_distances',
              'vertices')
# CPU against the card over FVM_SUITE's 3 steps, per step: BiCGStab at tolerance 1e-5 leaves noise of the solves'
# size. A 1e-7 relative perturbation of the initial velocity moves JAX's own pressure by up to 6.5e-4 / 3.3e-3 /
# 1.1e-3 of its scale at steps 1 / 2 / 3 and its pressure iterations over 63-67 / 63-73 / 48-53 (eight seeds; the
# port's, on the CPU: 7.7e-4 / 4.3e-3 / 1.7e-3, 63-67 / 65-71 / 45-52). The velocity is held to 3e-4, the pressure
# to 3e-3 at step 1 and 1e-2 after, the momentum iterations to 2 apart, the pressure iterations to 25% of the CPU's.
FVM_CPU_CARD_TOL = {'velocity': (3e-4, 3e-4, 3e-4), 'pressure': (3e-3, 1e-2, 1e-2)}
FVM_PRESSURE_ITERATIONS_REL = 0.25


def fvm_step(model, v, p):
    """One Field step of the wake and its two solves' (iterations, converged)."""
    from phiflow_tpu_torch.math import SolveTape
    with SolveTape() as tape:
        v, p = model.step(v, p)
    return v, p, [(info.iterations, info.converged) for info in tape]


def run_fvm(tag, warmup, steps):
    """CylinderWake on the card through its Field `step`: the mesh's build on
    the host (the model's constructor, the tables' one copy to the card
    included), ms a step, Mcells/s, each step's momentum and pressure
    iterations and convergence, the syncs of the last warm-up step,
    `max_memory_allocated`, max |v| and drag and lift (`forces(p) / dt`); no
    kernel of ours launched, the state on the model's mesh (no table copied),
    finite and max |v| < 3. Returns the launch counts."""
    import torch
    from phiflow_tpu_torch.models import CylinderWake
    from phiflow_tpu_torch.ops import _build
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = CylinderWake(**FVM_SIZES[tag], device='cuda')
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    v, p = model.initial_state()
    warm = []
    for k in range(warmup):
        if k < warmup - 1:
            v, p, its = fvm_step(model, v, p)
        else:  # the last warm-up step also counts its syncs
            syncs, sync_lines, (v, p, its) = syncs_a_step(lambda state: fvm_step(model, *state), (v, p))
        warm.append(its)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    solves = []
    t0 = time.perf_counter()
    for _ in range(steps):
        v, p, its = fvm_step(model, v, p)
        solves.append(its)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    launches = {k: n for k, n in _build.LAUNCHES.items() if n}
    peak = torch.cuda.max_memory_allocated()
    vel, pres = v.values.native(('cells', 'vector')), p.values.native(('cells',))
    finite = bool(torch.isfinite(vel).all()) and bool(torch.isfinite(pres).all())
    v_max = float(vel.abs().max())
    drag, lift = (model.forces(p) / model.dt).numpy(('vector',)).tolist()
    on_mesh = v.geometry is model.mesh and p.geometry is model.mesh

    def text(step_solves):
        return '; '.join(f'momentum {m} ({"converged" if mc else "not converged"}), pressure {q} '
                         f'({"converged" if qc else "not converged"})' for (m, mc), (q, qc) in step_solves)
    print(f'{tag} {model.n_cells} cells: mesh built on the host in {build_s:.2f} s (tables to the card included); '
          f'{ms:.2f} ms/step over {steps} Field step(s) after {warmup} warm-up step(s), '
          f'{model.n_cells / ms * 1e-3:.4f} Mcells/s; BiCGStab iterations of the timed steps: {text(solves)}; '
          f'syncs in warm-up step {warmup} {syncs} {sync_lines or ""} (its iterations: {text([warm[-1]])}); '
          f'max_memory_allocated {peak / 2 ** 30:.3f} GiB; max |v| {v_max:.4f}; drag {drag:.5f}, lift {lift:.5f} '
          f'(forces(p) / dt); kernels of ours launched: {launches or "none"}; the state on the model\'s mesh: '
          f'{on_mesh}; all finite: {finite}')
    bad = []
    if launches:
        bad.append(f'kernels of ours launched {launches}')
    if not finite or not v_max < FVM_V_MAX:
        bad.append(f'finite={finite}, max |v| {v_max} (< {FVM_V_MAX} expected)')
    if not on_mesh:
        bad.append("the state left the model's mesh")
    if bad:
        raise RuntimeError(f'{tag}: ' + '; '.join(bad))
    return dict(steps=steps)


def fvm_operators(mm, fields):
    """Every operator of `field/_mesh_math.py` on `fields` (s, v, flux, points)."""
    s, v, flux, points = fields
    return {
        'centroid_to_faces linear': mm.centroid_to_faces(s),
        'centroid_to_faces upwind': mm.centroid_to_faces(s, 'upwind', flux),
        'centroid_to_faces component': mm.centroid_to_faces(v, component='y'),
        'green_gauss_gradient': mm.green_gauss_gradient(s).values,
        'least_squares_gradient': mm.least_squares_gradient(s).values,
        'mesh_divergence': mm.mesh_divergence(v).values,
        'mesh_laplace scalar': mm.mesh_laplace(s).values,
        'mesh_laplace scalar correct_skew': mm.mesh_laplace(s, correct_skew=True).values,
        'mesh_laplace vector': mm.mesh_laplace(v).values,
        'mesh_laplace vector correct_skew': mm.mesh_laplace(v, correct_skew=True).values,
        'mesh_laplace_diagonal correct_skew': mm.mesh_laplace_diagonal(s),
        'mesh_laplace_diagonal': mm.mesh_laplace_diagonal(s, correct_skew=False),
        'mesh_advection_differential upwind': mm.mesh_advection_differential(v, v).values,
        'mesh_advection_differential linear': mm.mesh_advection_differential(v, v, upwind=False).values,
        'sample_mesh_field scalar': mm.sample_mesh_field(s, points, 'center', None, None),
        'sample_mesh_field vector': mm.sample_mesh_field(v, points, 'center', None, None),
    }


def fvm_cpu_vs_card():
    """The default wake's mesh tables on the card bit-equal to the host's
    build; every FVM operator on it, seeded random values, within 1e-5 of the
    output's scale on the CPU and the card; the JAX suite's wake at solve_tol
    1e-5 over 3 steps on both (FVM_CPU_CARD_TOL)."""
    import numpy as np
    import torch
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.field import Field, _mesh_math as mm
    from phiflow_tpu_torch.geom import Point, build_mesh
    from phiflow_tpu_torch.math import channel, dual, extrapolation, instance, vec, wrap
    from phiflow_tpu_torch.models import CylinderWake
    card = CylinderWake(device='cuda')
    with math.default_device('cpu'):
        host = build_mesh(card.domain, x=400, y=128, obstacles=card.cylinder)
    unequal = [t for t in FVM_TABLES if not np.array_equal(getattr(host, t).numpy(getattr(host, t).shape.names),
                                                           getattr(card.mesh, t).numpy(getattr(host, t).shape.names))]
    same_groups = host.boundaries == card.mesh.boundaries
    print(f'cpu vs card, CylinderWake() mesh ({host.cell_count} cells): the {len(FVM_TABLES)} tables on the card '
          f'bit-equal to the host build: {not unequal} {unequal or ""}; boundary groups equal: {same_groups}')
    if unequal or not same_groups:
        raise RuntimeError(f'FVM mesh tables differ between the host build and the card: {unequal}')
    rng = np.random.default_rng(3)
    n = host.cell_count
    s, v = rng.standard_normal(n).astype(np.float32), rng.standard_normal((n, 2)).astype(np.float32)
    flux = rng.standard_normal((n, 4)).astype(np.float32)
    pts = rng.uniform((0.2, 0.2), (7.8, 3.8), (256, 2)).astype(np.float32)
    zg = extrapolation.ZERO_GRADIENT
    out = {}
    for dev, mesh in (('cpu', host), ('cuda', card.mesh)):
        with math.default_device(dev):
            fields = (Field(mesh, wrap(torch.from_numpy(s).to(dev), instance('cells')),
                            {'x-': 1., 'x+': zg, 'y-': 0.5, 'y+': 0., 'boundary': 0.}),
                      Field(mesh, wrap(torch.from_numpy(v).to(dev), instance('cells'), channel(vector='x,y')),
                            {'x-': vec(x=1., y=0.), 'x+': zg, 'y-': vec(x=1., y=0.), 'y+': vec(x=1., y=0.),
                             'boundary': 0.}),
                      wrap(torch.from_numpy(flux).to(dev), instance('cells'), dual(faces=4)),
                      Point(wrap(torch.from_numpy(pts).to(dev), instance('points'), channel(vector='x,y'))))
            out[dev] = {k: t.numpy(sorted(t.shape.names)) for k, t in fvm_operators(mm, fields).items()}
    bad = []
    for name, ref in out['cpu'].items():
        got = out['cuda'][name]
        scale = float(np.abs(ref).max())
        err = float(np.abs(got - ref).max()) / scale
        ok = err <= 1e-5 and bool(np.isfinite(got).all())
        print(f'cpu vs card, FVM operator {name:36s} max |diff| / scale {err:.3e} (tol 1e-05, scale {scale:.4g}) '
              f'{"ok" if ok else "FAIL"}')
        if not ok:
            bad.append(name)
    if bad:
        raise RuntimeError(f'FVM operators disagree between the CPU and the card: {bad}')
    del card
    runs = {}
    for dev in ('cpu', 'cuda'):
        with math.default_device(dev):
            model = CylinderWake(**FVM_SUITE, device=dev)
            v, p = model.initial_state()
            states = []
            for _ in range(3):
                v, p, its = fvm_step(model, v, p)
                states.append((v.values.numpy(('cells', 'vector')), p.values.numpy(('cells',)), its))
            runs[dev] = states
    for k, ((vc, pc, ic), (vg, pg, ig)) in enumerate(zip(runs['cpu'], runs['cuda'])):
        dv = float(np.abs(vc - vg).max()) / float(np.abs(vc).max())
        dp = float(np.abs(pc - pg).max()) / float(np.abs(pc).max())
        tv, tp = FVM_CPU_CARD_TOL['velocity'][k], FVM_CPU_CARD_TOL['pressure'][k]
        (mc, mc_ok), (qc, qc_ok) = ic
        (mg, mg_ok), (qg, qg_ok) = ig
        ok = (dv <= tv and dp <= tp and abs(mc - mg) <= 2 and qc_ok and qg_ok and mc_ok and mg_ok
              and abs(qc - qg) <= FVM_PRESSURE_ITERATIONS_REL * qc and np.isfinite(vg).all() and np.isfinite(pg).all())
        print(f'cpu vs card, CylinderWake({FVM_SUITE["nx"]}x{FVM_SUITE["ny"]}, solve_tol 1e-5) step {k + 1}: max |diff| '
              f'/ scale velocity {dv:.3e} (tol {tv:g}), pressure {dp:.3e} (tol {tp:g}); iterations momentum {mc} / {mg}, '
              f'pressure {qc} / {qg} (cpu / card), all converged: {mc_ok and mg_ok and qc_ok and qg_ok} '
              f'{"ok" if ok else "FAIL"}')
        if not ok:
            raise RuntimeError(f'CPU and card disagree (CylinderWake step {k + 1}): {dv}, {dp}, {ic}, {ig}')
    torch.cuda.empty_cache()


def run_fvm_models():
    """The "FVM" phase: the default wake (1 warm-up, 1 timed step), the
    1600 × 512 one (1 + 1), then CPU against the card.
    Returns the launch counts by path."""
    import torch
    t0 = time.perf_counter()
    by_path = {}
    for tag, (warmup, steps) in FVM_RUNS.items():
        by_path[tag] = run_fvm(tag, warmup, steps)
        torch.cuda.empty_cache()
    fvm_cpu_vs_card()
    print(f'FVM: {time.perf_counter() - t0:.1f} s')
    return by_path


def profile_fvm():
    """Field steps of each FVM size under the profiler (2 + 2 at the default,
    0 + 1 at 1600 × 512): device busy ms, device kernels and host→device
    copies a step, the top operations."""
    import torch
    from phiflow_tpu_torch.models import CylinderWake
    for tag, (warmup, steps) in (('cylinder-wake', (2, 2)), ('cylinder-wake-1600x512', (0, 1))):
        model = CylinderWake(**FVM_SIZES[tag], device='cuda')
        profile_path(tag, f'{model.n_cells} cells', lambda state: model.step(*state), model.initial_state(),
                     warmup=warmup, steps=steps, rows_shown=12)
        del model
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 6: gradients
# ---------------------------------------------------------------------------

GRAD_NAMES = {3: 'window_interp_3d_grad', 2: 'window_interp_2d_grad'}
GRAD_TOL = 1e-5  # of each gradient's largest entry: the kernel and the twin sum the taps in different orders
GRAD_CG_TOL = 1e-5  # the differentiated paths' solves (forward and adjoint)
# at 4096² the float32 residual b − Ax of the 2D projection stops near 1e-4 of |b|: CG reaches 1e-5 only on its
# recurrence's drift away from the true residual
GRAD_CG_TOL_4096 = 1e-4


def _grad_call(d, grid, disps, K, extrema, scale, mode, const, ups, plain, word=False):
    """K6ᵀ / K7ᵀ (`plain` False) or the twin's VJP (True): (d_grid, [d_disp]). `word`: True, the backward as
    autograd runs it, after a forward of the same grid (K6 / K7) that leaves its verdict on the grid for the
    backward to read in place of its own test; a word such a forward wrote (`_forward_word`), the backward alone
    as autograd runs it; False, the bare backward, which tests the grid itself."""
    from phiflow_tpu_torch.ops import interp as I
    name = f'window_interp_{d}d'
    args = (grid, list(disps), K, extrema, tuple(I._f32(x) for x in scale), mode, I._f32(const), ups, True, True)
    if plain:
        return I._window_interp_vjp_plain(*args)
    if word is True:
        word = _forward_word(d, grid, disps, K, extrema, scale, mode, const)
    return I._window_interp_grad_cuda(name, *args, verdict=None if word is False else word)


def _forward_word(d, grid, disps, K, extrema, scale, mode, const):
    """The verdict on `grid` that a forward call of K6 / K7 writes for its backward (`_WindowInterp`)."""
    import torch
    from phiflow_tpu_torch.ops import interp as I
    word = torch.empty(1, dtype=torch.int32, device=grid.device)
    I._window_interp_cuda(f'window_interp_{d}d', grid, list(disps), K, extrema, tuple(I._f32(x) for x in scale),
                          mode, I._f32(const), verdict=word)
    return word


def _autograd_call(d, grid, disps, K, extrema, scale, mode, const, ups):
    """K6ᵀ / K7ᵀ through `torch.autograd.grad` of the public lookup (`_WindowInterp`, the forward's verdict carried
    in its context): (d_grid, [d_disp]) for the cotangents `ups` (out[, lo, up]; None entries absent)."""
    import torch
    from phiflow_tpu_torch.ops import interp as I
    fn = I.window_interp_3d if d == 3 else I.window_interp_2d
    halo = {None: {}, 'const': dict(const_pad=const), 'edge': dict(halo='edge'), 'wrap': dict(halo='wrap')}[mode]
    g_in = grid.detach().requires_grad_()
    d_in = [dd.detach().requires_grad_() for dd in disps]
    outs = fn(g_in, d_in, K, compute_extrema=extrema, disp_scale=scale, **halo)
    outs = outs if extrema else (outs,)
    pairs = [(o, u) for o, u in zip(outs, ups) if u is not None]
    res = torch.autograd.grad([o for o, _ in pairs], [g_in, *d_in], [u for _, u in pairs])
    return res[0], list(res[1:])


def _grad_compare(ch, d, case, got, ref):
    (g_grid, g_disp), (r_grid, r_disp) = got, ref
    for what, g, r in [('d_grid', g_grid, r_grid)] + [(f'd_disp[{i}]', a, b) for i, (a, b) in
                                                      enumerate(zip(g_disp, r_disp))]:
        ch.compare(GRAD_NAMES[d], f'{case} {what}', g, r, GRAD_TOL * max(float(r.abs().max()), 1e-30))


def _grad_compare_nan(ch, d, case, got, ref):
    """`_grad_compare` for gradients in which NaN is data: the NaN patterns equal, the rest within GRAD_TOL of
    each gradient's largest finite entry."""
    import torch
    (g_grid, g_disp), (r_grid, r_disp) = got, ref
    for what, g, r in [('d_grid', g_grid, r_grid)] + [(f'd_disp[{i}]', a, b) for i, (a, b) in
                                                      enumerate(zip(g_disp, r_disp))]:
        ch.compare_with_nan(GRAD_NAMES[d], f'{case} {what}', g, r,
                            GRAD_TOL * max(float(torch.nan_to_num(r, nan=0.0).abs().max()), 1e-30))


def _grad_repeat(ch, d, case, got, again):
    """Two launches on the same inputs: both gradients bit-equal (the grid's is a gather in a fixed order)."""
    for what, g, r in [('d_grid', got[0], again[0])] + [(f'd_disp[{i}]', a, b) for i, (a, b) in
                                                        enumerate(zip(got[1], again[1]))]:
        ch.compare(GRAD_NAMES[d], f'{case} {what} repeat launch (bit-equal)', g, r, 0.0)


def _grid_sample_backward(grid, disps, K, scale, padding_mode, g):
    """The gradient of `F.grid_sample` (forward and backward, one autograd
    call) for the same lookup, with respect to the grid and the sample
    coordinates: the library yardstick of K6ᵀ / K7ᵀ (a leading batch axis
    as grid_sample's N)."""
    import torch
    d = len(disps)
    coord_grid = _sample_coords(grid, disps, K, scale).detach().requires_grad_()
    spatial = tuple(grid.shape[grid.ndim - d:])
    inp = grid.reshape((-1, 1) + spatial).detach().requires_grad_()
    up = g.reshape((-1, 1) + spatial)
    F = torch.nn.functional
    return lambda: torch.autograd.grad(F.grid_sample(inp, coord_grid, mode='bilinear', padding_mode=padding_mode,
                                                     align_corners=True), (inp, coord_grid), up)


def _poison(t, gen, bad, shell=0):
    """`t` with about one cell in 400 (at least 3) NaN, +inf or -inf ('nan', 'inf', 'mixed': the three in turn);
    with `shell` > 0 also one cell of its outer `shell` layers (a padded grid's halo, which no output's own
    position reaches)."""
    import torch
    t = t.clone()
    flat = t.view(-1)
    n = max(3, flat.numel() // 400)
    idx = torch.randint(0, flat.numel(), (n,), generator=gen, device=t.device)
    vals = {'nan': [float('nan')], 'inf': [float('inf')], 'mixed': [float('nan'), float('inf'), float('-inf')]}[bad]
    flat[idx] = torch.tensor(vals, device=t.device).repeat(-(-n // len(vals)))[:n]
    if shell:
        t[(0,) * t.ndim] = vals[-1]
        t[tuple(n - 1 for n in t.shape[:-1]) + (t.shape[-1] // 2,)] = vals[0]
    return t


def check_grid_nonfinite(ch, gen):
    """Fault 3.13: a NaN or an infinity in the grid of a window lookup. K6 / K7 (value; lo / up exactly), K6ᵀ /
    K7ᵀ (the slot kernel in every halo form, the wide kernel at 3D K = 8 and 2D K = 33; both gradients, with and
    without the
    output's own cotangent, each launched twice: bit-equal) and K5 (its calls with a non-finite smoke or
    velocity) against their twins, which follow JAX's window sum: the NaN and +-inf patterns equal, the finite
    entries within the usual tolerances. Every halo form, K = 1 and 2, padded grids with a non-finite cell in
    their halo, a constant halo that is NaN. After each non-finite call a finite one: the flag was lowered.
    Fault 3.14: K6ᵀ / K7ᵀ also as autograd runs them, after a forward of the grid that leaves its verdict for the
    backward (bit-equal to the bare call, which tests the grid itself), and on grids whose one bad cell is a core
    cell that only d_disp's own-cell test used to find: bare, with the forward's word, and through
    `torch.autograd.grad` of the public lookup."""
    import torch
    from phiflow_tpu_torch.ops import interp as I
    from phiflow_tpu_torch.ops.advect3d import fused_advect_3d, _fused_advect_plain
    dev = 'cuda'
    fns = {3: (I.window_interp_3d, 'window_interp_3d'), 2: (I.window_interp_2d, 'window_interp_2d')}

    def lookup(d, grid, disps, K, extrema, scale, mode, const, plain):
        if plain:
            return I._window_interp_plain(grid, list(disps), K, extrema, tuple(I._f32(x) for x in scale), mode,
                                          I._f32(const))
        halo = {None: {}, 'const': dict(const_pad=const), 'edge': dict(halo='edge'), 'wrap': dict(halo='wrap')}[mode]
        return fns[d][0](grid, disps, K, compute_extrema=extrema, disp_scale=scale, **halo)

    for d, shape in ((3, SMALL), (2, (37, 45))):
        scale = (0.8, -1.1, 0.6)[:d]
        name = fns[d][1]
        for K in (1, 2):
            disps = (torch.rand((d,) + shape, generator=gen, device=dev) * 2 - 1) * ((K + 1) / 0.6)
            for mode in (None, 'const', 'edge', 'wrap'):
                gshape = tuple(n + 2 * K for n in shape) if mode is None else shape
                clean = torch.randn(gshape, generator=gen, device=dev)
                for bad in ('nan', 'mixed'):
                    grid = _poison(clean, gen, bad, shell=K if mode is None else 0)
                    for extrema in (False, True):
                        case = f'{shape} K={K} {mode or "padded"}{" extrema" if extrema else ""}, grid {bad}'
                        got = lookup(d, grid, disps, K, extrema, scale, mode, 0.25, False)
                        ref = lookup(d, grid, disps, K, extrema, scale, mode, 0.25, True)
                        got, ref = (got, ref) if extrema else ((got,), (ref,))
                        ch.compare_nonfinite(name, case + ' value', got[0], ref[0], 1e-5)
                        for what, g, r in zip(('lo', 'up'), got[1:], ref[1:]):
                            ch.compare_nonfinite(name, f'{case} {what} (exact)', g, r, 0.0)
                got = lookup(d, clean, disps, K, True, scale, mode, 0.25, False)
                ref = lookup(d, clean, disps, K, True, scale, mode, 0.25, True)
                ch.compare(name, f'{shape} K={K} {mode or "padded"}, a finite grid after them value', got[0], ref[0],
                           1e-5)
            raw = torch.randn(shape, generator=gen, device=dev)
            got = lookup(d, raw, disps, K, False, scale, 'const', float('nan'), False)
            ref = lookup(d, raw, disps, K, False, scale, 'const', float('nan'), True)
            ch.compare_nonfinite(name, f'{shape} K={K} a NaN constant halo value', got, ref, 1e-5)
    # K6ᵀ / K7ᵀ: the slot kernel in every halo form, the wide kernel (3D K = 8, 2D K = 33; their twins' (2K + 1)^D
    # taps cost seconds a call)
    for d, shape, K, mode in ((3, SMALL, 1, 'edge'), (3, SMALL, 1, 'const'), (3, SMALL, 1, None),
                              (3, (4, 3, 37), 2, 'wrap'), (2, (37, 45), 1, 'const'), (2, (37, 45), 1, 'edge'),
                              (2, (37, 45), 2, 'wrap'), (2, (37, 45), 2, None), (3, (6, 10, 24), 8, 'edge'),
                              (2, (24, 40), 33, 'const')):
        scale = (0.8, -1.1, 0.6)[:d]
        clean = torch.randn(tuple(n + 2 * K for n in shape) if mode is None else shape, generator=gen, device=dev)
        disps = list((torch.rand((d,) + shape, generator=gen, device=dev) * 2 - 1) * ((K + 1) / 0.6))
        for bad in ('mixed',):
            grid = _poison(clean, gen, bad, shell=K if mode is None else 0)
            # the wide kernel's twin takes seconds a call: lo / up's cotangents alone at the slot kernel's K only
            for cotangents in ('out + lo + up',) if K > 7 else ('out + lo + up', 'lo + up only'):
                ups = [torch.randn(shape, generator=gen, device=dev) for _ in range(3)]
                if cotangents == 'lo + up only':
                    ups[0] = None
                case = f'{shape} K={K} {mode or "padded"} extrema, grid {bad}, {cotangents}'
                got = _grad_call(d, grid, disps, K, True, scale, mode, 0.25, ups, False)
                ref = _grad_call(d, grid, disps, K, True, scale, mode, 0.25, ups, True)
                again = _grad_call(d, grid, disps, K, True, scale, mode, 0.25, ups, False)
                # as autograd runs it: the forward's verdict in place of d_disp's test, the same launches after it
                word = _grad_call(d, grid, disps, K, True, scale, mode, 0.25, ups, False, word=True)
                for what, g, r, a, w in ([('d_grid', got[0], ref[0], again[0], word[0])] +
                                         [(f'd_disp[{i}]', x, y, z, v) for i, (x, y, z, v) in
                                          enumerate(zip(got[1], ref[1], again[1], word[1]))]):
                    fin = torch.isfinite(r)
                    tol = GRAD_TOL * max(float(torch.where(fin, r, 0.0).abs().max()), 1e-30)
                    ch.compare_nonfinite(GRAD_NAMES[d], f'{case} {what}', g, r, tol)
                    ch.compare_nonfinite(GRAD_NAMES[d], f'{case} {what} repeat launch (bit-equal)', g, a, 0.0)
                    ch.compare_nonfinite(GRAD_NAMES[d], f'{case} {what} with the forward\'s word', w, r, tol)
                    ch.compare_nonfinite(GRAD_NAMES[d], f'{case} {what} with the forward\'s word = bare (bit-equal)',
                                         w, g, 0.0)
        if K > 7:  # the flag's lowering after the wide calls is held by the finite calls that follow
            continue
        got = _grad_call(d, clean, disps, K, True, scale, mode, 0.25, ups, False)
        _grad_compare(ch, d, f'{shape} K={K} {mode or "padded"} extrema, a finite grid after them', got,
                      _grad_call(d, clean, disps, K, True, scale, mode, 0.25, ups, True))
        got = _grad_call(d, clean, disps, K, True, scale, mode, 0.25, ups, False, word=True)
        _grad_compare(ch, d, f'{shape} K={K} {mode or "padded"} extrema, a finite grid after them, with the '
                             f'forward\'s word', got, _grad_call(d, clean, disps, K, True, scale, mode, 0.25, ups, True))
    # fault 3.14: one bad cell that only d_disp's own-cell test finds (a cell of the grid's core, which no shell
    # test reads): bare (d_disp's test), with the forward's word, and through torch.autograd.grad (_WindowInterp)
    for d, shape, K, mode in ((3, SMALL, 1, 'edge'), (3, SMALL, 1, 'const'), (3, SMALL, 1, None),
                              (3, (4, 3, 37), 2, 'wrap'), (2, (37, 45), 1, 'const'), (2, (37, 45), 1, 'edge'),
                              (2, (37, 45), 2, 'wrap'), (2, (37, 45), 2, None)):
        scale = (0.8, -1.1, 0.6)[:d]
        grid = torch.randn(tuple(n + 2 * K for n in shape) if mode is None else shape, generator=gen, device=dev)
        disps = list((torch.rand((d,) + shape, generator=gen, device=dev) * 2 - 1) * ((K + 1) / 0.6))
        ups = [torch.randn(shape, generator=gen, device=dev) for _ in range(3)]
        for bad in (float('nan'), float('inf')) if mode == 'edge' else (float('nan'),):  # an infinity in one per rank
            lone = grid.clone()
            lone[tuple(n // 2 for n in lone.shape)] = bad
            case = f'{shape} K={K} {mode or "padded"} extrema, one {bad} core cell'
            ref = _grad_call(d, lone, disps, K, True, scale, mode, 0.25, ups, True)
            for form, got in (('bare', _grad_call(d, lone, disps, K, True, scale, mode, 0.25, ups, False)),
                              ('forward\'s word', _grad_call(d, lone, disps, K, True, scale, mode, 0.25, ups, False,
                                                             word=True)),
                              ('autograd', _autograd_call(d, lone, disps, K, True, scale, mode, 0.25, ups))):
                for what, g, r in [('d_grid', got[0], ref[0])] + [(f'd_disp[{i}]', x, y) for i, (x, y) in
                                                                 enumerate(zip(got[1], ref[1]))]:
                    tol = GRAD_TOL * max(float(torch.where(torch.isfinite(r), r, 0.0).abs().max()), 1e-30)
                    ch.compare_nonfinite(GRAD_NAMES[d], f'{case}, {form} {what}', g, r, tol)
        got = _autograd_call(d, grid, disps, K, True, scale, mode, 0.25, ups)
        _grad_compare(ch, d, f'{shape} K={K} {mode or "padded"} extrema, autograd on a finite grid after them', got,
                      _grad_call(d, grid, disps, K, True, scale, mode, 0.25, ups, True))
    # K5: a non-finite smoke in calls 1 and 2 and the staggered outputs of a scalar, a non-finite velocity in call 3
    for K in (1, 2):
        for periodic in (False, True):
            vel_t, smoke = _advect_inputs(SMALL, gen, dev, K, periodic)
            for bad in ('mixed',):
                s_bad = _poison(smoke, gen, bad)
                v_bad = [_poison(v, gen, bad) for v in vel_t]
                scales, calls = _advect_calls(SMALL, K, vel_t, s_bad, periodic)
                _, nan_calls = _advect_nan_calls(SMALL, K, vel_t, s_bad, periodic, gen)
                _, v_calls = _advect_calls(SMALL, K, v_bad, smoke, periodic)
                runs = [calls[0], calls[1], nan_calls[2], v_calls[2]]
                for what, srcs, outs, extras in runs:
                    got = fused_advect_3d(srcs, SMALL, K, outs, scales, extras)
                    ref = _fused_advect_plain(srcs, SMALL, K, outs, scales, extras)
                    for i, (g, r) in enumerate(zip(got, ref)):
                        g = g if isinstance(g, tuple) else (g,)
                        r = r if isinstance(r, tuple) else (r,)
                        for j, (gg, rr) in enumerate(zip(g, r)):
                            exact = outs[i].extrema and j in (1, 2)
                            ch.compare_nonfinite('fused_advect', f'{what} out{i}.{j}{" (exact)" if exact else ""} K={K}'
                                                 f'{" periodic" if periodic else ""}, {bad} grid', gg, rr,
                                                 0.0 if exact else 2e-5)
            scales, calls = _advect_calls(SMALL, K, vel_t, smoke, periodic)
            what, srcs, outs, extras = calls[0]
            got, ref = fused_advect_3d(srcs, SMALL, K, outs, scales, extras), _fused_advect_plain(
                srcs, SMALL, K, outs, scales, extras)
            ch.compare('fused_advect', f'{what} K={K}{" periodic" if periodic else ""}, finite after them',
                       got[0][0], ref[0][0], 2e-5)


def check_interp_grad(ch, gen, quick):
    """K6ᵀ / K7ᵀ against the twin's VJP (autograd of the window sum in the JAX
    package's AD conventions) on the card, both gradients within 1e-5 of each
    one's largest entry: every halo form, K = 1 and 2, with and without the
    extrema's upstream gradients at one small shape a rank (the ragged rows
    in two forms), fractional, clipped and integer displacements; the one-slot-plane route (3D K = 6, 2D K = 24), wrapped
    axes of at most 2K cells, the wide kernel past the slot window (3D K = 8,
    2D K = 33: in 3D padded, wrapped and a batch on a shared grid, in 2D
    a shared grid's clamped sides), empty outputs
    (zero gradients, no launch counted), NaN displacements (JAX's rule:
    against the twin on the same inputs, the same NaN pattern — d_grid NaN
    at every tap of a NaN output, d_disp NaN on its finite axes and exactly
    0 on a lone NaN axis; none with lo / up's cotangents alone — in every
    halo form and the one-slot-plane route, and the wide kernel with the
    output's cotangent); each form
    launched twice, bit-equal; then (not with --quick) at the paths' shapes,
    timed, and the wide kernel timed at 48³ K = 8."""
    import torch
    dev = 'cuda'

    def rnd(shape):
        return torch.randn(shape, generator=gen, device=dev)

    # every form (K, halo, extrema) at one small shape a rank; the ragged rows (scalar loads, border blocks) in
    # two forms each
    every_form = [(K, mode, extrema) for K in (1, 2) for mode in (None, 'const', 'edge', 'wrap')
                  for extrema in (False, True)]
    two_forms = [(1, None, True), (2, 'edge', True)]
    for d, shape, forms in ((3, SMALL, every_form), (3, K6_RAGGED, two_forms), (2, SMALL[1:], every_form),
                            (2, (37, 45), two_forms)):
        scale = (0.8, -1.1, 0.6)[:d]
        for K, mode, extrema in forms:
            gshape = tuple(n + 2 * K for n in shape) if mode is None else shape
            grid = rnd(gshape)
            disps = list((torch.rand((d,) + shape, generator=gen, device=dev) * 2 - 1) * ((K + 1) / 0.6))
            ups = [rnd(shape) for _ in range(3 if extrema else 1)]
            case = f'{shape} K={K} {mode or "padded"}{" extrema" if extrema else ""}'
            got = _grad_call(d, grid, disps, K, extrema, scale, mode, 0.25, ups, False)
            _grad_compare(ch, d, case, got, _grad_call(d, grid, disps, K, extrema, scale, mode, 0.25, ups, True))
            _grad_repeat(ch, d, case, got, _grad_call(d, grid, disps, K, extrema, scale, mode, 0.25, ups, False))
        K = 2
        grid = torch.round(rnd(tuple(n + 2 * K for n in shape)) * 2) / 2  # ties in the extrema chain
        ints = list(torch.randint(-1, 2, (d,) + shape, generator=gen, device=dev).float() * K)  # −K, 0, +K
        ints[0] = torch.zeros_like(ints[0])  # from rest along axis 0: the taps beside it carry half a slope
        ups = [rnd(shape) for _ in range(3)]
        case = f'{shape} K={K} padded, integer displacements 0 and ±K, tied values'
        got = _grad_call(d, grid, ints, K, True, (1.0,) * d, None, 0.0, ups, False)
        _grad_compare(ch, d, case, got, _grad_call(d, grid, ints, K, True, (1.0,) * d, None, 0.0, ups, True))
        _grad_repeat(ch, d, case, got, _grad_call(d, grid, ints, K, True, (1.0,) * d, None, 0.0, ups, False))
    # the one-slot-plane route (the ring of 2K + 2 planes past 227 KB), wrapped axes of at most 2K cells
    for d, shape, K, mode in ((3, (10, 20, 40), 6, 'const'), (2, (40, 300), 24, 'edge'), (3, (4, 3, 37), 2, 'wrap'),
                              (2, (3, 50), 2, 'wrap'), (3, (2, 2, 40), 1, 'wrap')):
        scale = (0.8, -1.1, 0.6)[:d]
        grid = rnd(shape)
        disps = list((torch.rand((d,) + shape, generator=gen, device=dev) * 2 - 1) * ((K + 1) / 0.6))
        ups = [rnd(shape) for _ in range(3)]
        case = f'{shape} K={K} {mode} extrema'
        got = _grad_call(d, grid, disps, K, True, scale, mode, 0.25, ups, False)
        _grad_compare(ch, d, case, got, _grad_call(d, grid, disps, K, True, scale, mode, 0.25, ups, True))
        _grad_repeat(ch, d, case, got, _grad_call(d, grid, disps, K, True, scale, mode, 0.25, ups, False))
    # past the slot window (3D K > 7, 2D K > 32): the wide kernel, padded, wrapped and a batch on a shared grid
    # (edge) in 3D, the clamped sides of a shared grid in 2D (the twin's (2K + 1)^D taps cost ≈ 3 s a call: the
    # constant halo is held at the timed shapes below, a single edge grid by the NaN and non-finite checks)
    every = ((None, ()), ('wrap', ()), ('edge', (2,)))
    for d, shape, K, forms in ((3, (10, 20, 40), 8, every), (2, (40, 70), 33, every[2:])):
        scale = (0.8, -1.1, 0.6)[:d]
        for mode, lead in forms:
            grid = rnd(tuple(n + 2 * K for n in shape) if mode is None else shape)
            disps = list((torch.rand((d,) + lead + shape, generator=gen, device=dev) * 2 - 1) * ((K + 1) / 0.6))
            ups = [rnd(lead + shape) for _ in range(3)]
            case = f'{lead + shape} K={K} {mode or "padded"} extrema{", shared grid" if lead else ""} (wide)'
            got = _grad_call(d, grid, disps, K, True, scale, mode, 0.25, ups, False)
            _grad_compare(ch, d, case, got, _grad_call(d, grid, disps, K, True, scale, mode, 0.25, ups, True))
            _grad_repeat(ch, d, case, got, _grad_call(d, grid, disps, K, True, scale, mode, 0.25, ups, False))
    # empty outputs: zero gradients of the inputs' shapes, nothing launched (a padded grid of 2K cells along an
    # output axis of 0; an empty raw grid)
    from phiflow_tpu_torch.ops import _build
    for d, shape, mode in ((3, (0, 24, 40), None), (3, (0, 24, 40), 'const'), (2, (37, 0), None), (2, (0, 45), 'edge')):
        grid = torch.full(tuple(n + 2 for n in shape) if mode is None else shape, 7.0, device=dev)
        disps = [torch.ones(shape, device=dev) for _ in range(d)]
        ups = [torch.ones(shape, device=dev) for _ in range(3)]
        before = _build.LAUNCHES[GRAD_NAMES[d]]
        got = _grad_call(d, grid, disps, 1, True, (1.0,) * d, mode, 0.25, ups, False)
        case = f'{shape} K=1 {mode or "padded"} extrema, empty outputs'
        wrong = [f'{what} of shape {tuple(g.shape)}' for what, g, like in
                 [('d_grid', got[0], grid)] + [(f'd_disp[{i}]', x, y) for i, (x, y) in enumerate(zip(got[1], disps))]
                 if tuple(g.shape) != tuple(like.shape)]
        if _build.LAUNCHES[GRAD_NAMES[d]] != before:
            wrong.append(f'{_build.LAUNCHES[GRAD_NAMES[d]] - before} launches counted')
        if wrong:
            print(f'check {GRAD_NAMES[d]:17s} {case}: {", ".join(wrong)} FAIL')
            ch.failed.append(f'{GRAD_NAMES[d]} {case}')
            continue
        ch.compare(GRAD_NAMES[d], f'{case} d_grid {tuple(grid.shape)} (zeros)', got[0], torch.zeros_like(grid), 0.0)
    # NaN displacements, JAX's rule against the twin's VJP on the same inputs: with the output's
    # upstream gradient, d_grid NaN at each of a NaN output's (2K + 1)^D taps (edge: the edge cell; wrap: the
    # wrapped one; a constant halo drops them), d_disp NaN on its finite axes and exactly 0 on a lone NaN axis;
    # with lo / up's alone, no NaN anywhere and d_disp 0 there. Every halo form, K = 1 and 2, the one-slot-plane
    # route and the wide kernel; each launched twice, bit-equal (NaN patterns too)
    for d, shape, K, mode in ((3, SMALL, 1, 'edge'), (3, SMALL, 1, None), (3, SMALL, 2, 'const'),
                              (3, (4, 3, 37), 2, 'wrap'), (2, (37, 45), 1, 'edge'), (2, (37, 45), 2, None),
                              (2, (3, 50), 1, 'wrap'), (3, (10, 20, 40), 6, 'const'), (3, (6, 10, 24), 8, 'edge'),
                              (2, (40, 70), 33, 'const')):
        scale = (0.8, -1.1, 0.6)[:d]
        grid = rnd(tuple(n + 2 * K for n in shape) if mode is None else shape)
        disps, lone = _with_nan(list((torch.rand((d,) + shape, generator=gen, device=dev) * 2 - 1)
                                     * ((K + 1) / 0.6)), gen)
        # the wide kernel's twin takes seconds a call: lo / up's cotangents alone are held at the slot kernel's K
        for cotangents in ('out + lo + up',) if K > 7 else ('out + lo + up', 'lo + up only'):
            ups = [rnd(shape) for _ in range(3)]
            if cotangents == 'lo + up only':
                ups[0] = None
            case = f'{shape} K={K} {mode or "padded"} extrema, NaN displacements, {cotangents}'
            got = _grad_call(d, grid, disps, K, True, scale, mode, 0.25, ups, False)
            _grad_compare_nan(ch, d, case, got, _grad_call(d, grid, disps, K, True, scale, mode, 0.25, ups, True))
            if ups[0] is not None:
                ch.compare(GRAD_NAMES[d], f'{case} d_disp[{d - 1}] on a lone NaN axis (exactly 0)', got[1][-1][lone],
                           torch.zeros_like(got[1][-1][lone]), 0.0)
            else:
                ch.compare(GRAD_NAMES[d], f'{case} d_grid (no NaN, finite)', got[0], got[0], 0.0)
            again = _grad_call(d, grid, disps, K, True, scale, mode, 0.25, ups, False)
            for what, g, r in [('d_grid', got[0], again[0])] + [(f'd_disp[{i}]', a, b) for i, (a, b) in
                                                                enumerate(zip(got[1], again[1]))]:
                ch.compare_with_nan(GRAD_NAMES[d], f'{case} {what} repeat launch (bit-equal)', g, r, 0.0)
    if quick:
        return
    # --- the paths' shapes: a velocity component (constant halo) and the smoke's forward pass (edge halo,
    #     extrema), 256³ (K6ᵀ) and 4096² (K7ᵀ); Burgers' 128² (wrap, K = 2) ---
    for d, shape in ((3, (PATH_N,) * 3), (2, (PATH_N_2D,) * 2), (2, (128, 128))):
        name = GRAD_NAMES[d]
        burgers = shape == (128, 128)
        K, scale = (2, (-1.0, -1.0)) if burgers else (1, (-0.5,) * d)
        grid = torch.rand(shape, generator=gen, device=dev)
        disps = [torch.rand(shape, generator=gen, device=dev) * 5.0 - 2.5 for _ in range(d)]  # clips at ±K
        g = [rnd(shape) for _ in range(3)]
        forms = [('wrap', False)] if burgers else [('const', False), ('edge', True)]
        # each form as autograd runs it (the forward's word: the instantiation the paths launch) and bare
        words = {mode: _forward_word(d, grid, disps, K, extrema, scale, mode, 0.0) for mode, extrema in forms}
        for mode, extrema in forms:
            ups = g if extrema else g[:1]
            case = f'{shape} K={K} {mode}{" extrema" if extrema else ""}{" (Burgers)" if burgers else ""}'
            ref = _grad_call(d, grid, disps, K, extrema, scale, mode, 0.0, ups, True)
            _grad_compare(ch, d, f'{case}, with the forward\'s word',
                          _grad_call(d, grid, disps, K, extrema, scale, mode, 0.0, ups, False, word=words[mode]), ref)
            _grad_compare(ch, d, f'{case}, bare', _grad_call(d, grid, disps, K, extrema, scale, mode, 0.0, ups, False),
                          ref)
            del ref
        torch.cuda.empty_cache()
        if burgers:
            continue
        n = grid.numel()
        # per output: 2^d corners of a weight product, d slopes of d − 1 products, d sums and the cell's sum; 4
        # taps an axis of tent arithmetic
        ops = (2 ** d * (d * d + d + 1) + 32 * d) * n
        for mode, extrema in forms:
            ups = g if extrema else g[:1]
            what = (f'{"smoke forward: edge halo + extrema" if extrema else "velocity component: const halo"}, '
                    f'{shape} K=1')
            lib = _grid_sample_backward(grid, disps, K, scale, 'border' if extrema else 'zeros', g[0])
            ch.time(name, what,
                    lambda: _grad_call(d, grid, disps, K, extrema, scale, mode, 0.0, ups, False, word=words[mode]),
                    lambda: _grad_call(d, grid, disps, K, extrema, scale, mode, 0.0, ups, True),
                    nbytes(grid, *disps, *ups) + nbytes(grid, *disps), ops + (2 ** (d + 2) * n if extrema else 0),
                    lib, key=None if not extrema else name + ' +extrema')
            del lib
        # a side reading: the bare backward (a call without a forward's word, which tests the grid itself) of the
        # smoke's form, which the paths do not launch
        ch.side(name, f'smoke forward: edge halo + extrema, {shape} K=1, bare',
                lambda: _grad_call(d, grid, disps, K, True, scale, 'edge', 0.0, g, False), key=name + ' bare')
        ch.attach(name, [name + ' +extrema', name + ' bare'])
        del grid, disps, g, words
        torch.cuda.empty_cache()
    # the wide kernel (3D K = 8, 2D K = 33) on a velocity component with a constant halo: its d_grid reads the
    # (2K + 1)^D outputs within K of a cell; the bound counts the function's work, as the K = 1 rows do
    for d, shape, K in ((3, (48, 48, 48), 8), (2, (128, 128), 33)):
        name, scale = GRAD_NAMES[d], (-1.0,) * d
        grid = torch.rand(shape, generator=gen, device=dev)
        disps = [(torch.rand(shape, generator=gen, device=dev) * 2 - 1) * (K + 1) for _ in range(d)]  # clips at ±K
        ups = [rnd(shape)]
        case = f'wide kernel: const halo, {shape} K={K}'
        word = _forward_word(d, grid, disps, K, False, scale, 'const', 0.0)
        ref = _grad_call(d, grid, disps, K, False, scale, 'const', 0.0, ups, True)
        _grad_compare(ch, d, f'{case}, with the forward\'s word',
                      _grad_call(d, grid, disps, K, False, scale, 'const', 0.0, ups, False, word=word), ref)
        _grad_compare(ch, d, f'{case}, bare', _grad_call(d, grid, disps, K, False, scale, 'const', 0.0, ups, False),
                      ref)
        del ref
        lib = _grid_sample_backward(grid, disps, K, scale, 'zeros', ups[0])
        ch.time(name, case, lambda: _grad_call(d, grid, disps, K, False, scale, 'const', 0.0, ups, False, word=word),
                lambda: _grad_call(d, grid, disps, K, False, scale, 'const', 0.0, ups, True),
                nbytes(grid, *disps, *ups) + nbytes(grid, *disps), (2 ** d * (d * d + d + 1) + 32 * d) * grid.numel(),
                lib, key=name + ' wide', plain_reps=1)
        ch.attach(name, [name + ' wide'])
        del grid, disps, ups, lib, word
        torch.cuda.empty_cache()


def check_p2g_grad(ch):
    """K8's values-gradient (`_P2GMean.backward`, a gather by indexing) on
    the card against the CPU, on FLIP's first-step inputs at 64³ onto the
    cells and the x faces: within 1e-6 of the largest entry."""
    import torch
    from phiflow_tpu_torch.ops import p2g as G
    gen = torch.Generator(device='cuda')
    gen.manual_seed(3)
    pos, vals = _flip_particles(64, gen, 'cuda')
    for grid in ('cells', 'x faces'):
        res, lower = _flip_grid(64, None if grid == 'cells' else 0)
        g = torch.randn(res, generator=gen, device='cuda')
        out = {}
        for dev in ('cuda', 'cpu'):
            v = vals.to(dev).requires_grad_()
            mean = G.p2g_mean(pos.to(dev), v, res, lower, (1.0,) * 3, False, float('nan'))
            out[dev], = torch.autograd.grad(torch.nan_to_num(mean, nan=0.0), v, g.to(dev))
        ref = out['cpu'].cuda()
        ch.compare('p2g_mean', f'values gradient card vs CPU, FLIP 64^3 first step onto the {grid}',
                   out['cuda'], ref, 1e-6 * max(float(ref.abs().max()), 1e-30))


def _smooth_weight(N, dims, period=None):
    """The loss's weight: a smooth seeded field of mean about 0. The
    MacCormack clamp's bounds change where a displacement crosses a whole
    cell, so L jumps there by a little; under a smooth weight those jumps
    cancel out of a finite difference, under a random one they do not."""
    import torch
    return torch.from_numpy(smooth_state(N, dims, seed=11, period=period)[dims] - 0.5)


def _loss_of(state, w64):
    """Σ w·smoke + Σ w[1:]·v_x in float64 (the x faces of the closed box
    are the cells' less one row): the final velocity enters too, so that
    every step's advection and projection lie on the gradient's path."""
    vel, smoke, _ = state
    return (smoke.double() * w64).sum() + (vel[0].double() * w64[1:]).sum()


def _smoke_grad(model, state, w, steps, record=None):
    """math.gradient of L = `_loss_of` after `steps` steps of the model's Field
    `step` from `state` (velocity components, smoke) with respect to the
    initial velocity and smoke: (L, dL/dv components, dL/ds). With `record`,
    the forward's end is synchronised and marked there, with its launches."""
    import torch
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.ops import _build
    w64 = w.double()

    def loss(v, s):
        p = None
        for _ in range(steps):
            v, s, p = model.step(v, s, p)
        out = _loss_of(model.state_natives(v, s, None), w64)
        if record is not None:
            torch.cuda.synchronize()
            record['forward_end'] = time.perf_counter()
            record['forward'] = dict(_build.LAUNCHES)
            record['memory_forward'] = torch.cuda.max_memory_allocated()
            _build.reset_launches()
        return out

    v, s, _ = model.state_fields(*state, None)
    value, gv, gs = math.gradient(loss, wrt=[0, 1], get_output=True)(v, s)
    gvel, gsmoke, _ = model.state_natives(gv, gs, None)
    return float(value), list(gvel), gsmoke


def _forward_loss(model, state, w, steps):
    """L of `_smoke_grad` on the differentiated path (inputs that require grad
    under grad mode: the per-phase advection), without the backward."""
    import torch
    leaves = [t.detach().requires_grad_() for t in (*state[0], state[1])]
    with torch.enable_grad():
        v, s, _ = model.state_fields(tuple(leaves[:-1]), leaves[-1], None)
        p = None
        for _ in range(steps):
            v, s, p = model.step(v, s, p)
        return float(_loss_of(model.state_natives(v, s, None), w.double()).detach())


def cg_dot_probe(N=PATH_N, steps=3, rounds=2, solves=5):
    """Why the projection's CG takes ⟨r, z⟩ after z's mean projection, and
    what that costs. Over the solves of grad-256's forward (`steps` steps of
    SmokePlume(N) from `smooth_state(N)` under grad, GRAD_CG_TOL): the gap
    between K2's emitted dot (taken before the projection) and the
    projected dot, relative to the latter, at each preconditioner call.
    Then ms a solve at the forward paths' cg_tol 1e-3 with the projected dot
    (the port's preconditioner) and with K2's, CUDA events over `solves`
    solves, early / projected / projected / early in each of `rounds`
    rounds. Printed, not gated."""
    import statistics
    import torch
    from phiflow_tpu_torch.field import face_layout
    from phiflow_tpu_torch.math._multigrid import make_poisson_vcycle
    from phiflow_tpu_torch.math._solve import _dot, cg, sub_mean
    from phiflow_tpu_torch.models import SmokePlume, state_from_numpy
    from phiflow_tpu_torch.physics import fluid
    gaps = []

    def recording(resolution, dx, bcs, device, singular=True, nb=0):  # the probe is unbatched: nb is 0
        vcycle = make_poisson_vcycle(tuple(resolution), tuple(dx) if isinstance(dx, (tuple, list))
                                     else (dx,) * len(resolution), bcs, device)
        gaps.append([])

        def M(r):
            z, early = vcycle(r, emit_dot=True)
            z = sub_mean(z)
            late = _dot(r, z)
            gaps[-1].append(torch.abs(early - late) / torch.abs(late))
            return z, None
        return M

    model = SmokePlume(resolution=N, dims=3, cg_tol=GRAD_CG_TOL, max_iterations=300, device='cuda')
    vel, smoke, _ = state_from_numpy(*smooth_state(N), device='cuda')
    port_preconditioner = fluid._grid_multigrid_preconditioner
    fluid._grid_multigrid_preconditioner = recording
    try:
        _forward_loss(model, (vel, smoke), _smooth_weight(N, 3).cuda(), steps)
    finally:
        fluid._grid_multigrid_preconditioner = port_preconditioner
    for k, solve in enumerate(gaps):
        print(f'cg dot {N}^3: grad-256 forward solve {k + 1} (cg_tol {GRAD_CG_TOL:.0e}): |K2 dot before the mean '
              f'projection - dot after| / |dot after| per preconditioner call '
              + ' '.join(f'{float(g):.2e}' for g in solve))
    vel = [torch.from_numpy(a).cuda() for a in smooth_state(N)[:3]]
    bcs = fluid.pressure_modes(face_layout(False, 3))
    rhs = sub_mean(fluid._balance_divergence(fluid.divergence_native(vel, 1.0)))
    zeros = torch.zeros_like(rhs)
    vcycle = make_poisson_vcycle((N,) * 3, (1.0,) * 3, bcs, 'cuda')

    def A(p):
        return fluid.poisson_apply(p, (1.0,) * 3, bcs, with_dot=True)

    def early_dot(r):
        z, early = vcycle(r, emit_dot=True)
        return sub_mean(z), early

    preconditioners = {'early': early_dot, 'projected': fluid._grid_multigrid_preconditioner((N,) * 3, 1.0, bcs,
                                                                                           rhs.device)}
    times = {name: [] for name in preconditioners}
    iterations = {name: cg(A, rhs, zeros, 1e-3, 1e-3, 100, M).iterations for name, M in preconditioners.items()}
    for _ in range(rounds):
        for name in ('early', 'projected', 'projected', 'early'):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(solves):
                cg(A, rhs, zeros, 1e-3, 1e-3, 100, preconditioners[name])
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / solves)
    print(f'cg dot {N}^3: ms a solve at cg_tol 1e-3 (CUDA events, {solves} solves a run): '
          + '; '.join(f'{name} dot {statistics.median(t):.4f} median of ' + ', '.join(f'{x:.4f}' for x in t)
                      + f' ({iterations[name]} iterations)' for name, t in times.items()))


def run_gradient_path(tag, dims, N, steps, period=None, cg_tol=GRAD_CG_TOL, ch=None):
    """The differentiated smoke rollout on the card: SmokePlume(N, dims) from
    `smooth_state(N)`, `steps` steps of the Field `step` under grad, L = Σ
    w·smoke + Σ w·v_x with w a smooth seeded weight (`_smooth_weight`),
    `math.gradient` with respect to the
    initial velocity and smoke. Prints the launches of the forward (K6 / K7,
    K1–K4) and of the backward (K6ᵀ / K7ᵀ, K1–K4 of the adjoint solves; K5
    must be 0), ms/step of the forward under grad and of forward + backward,
    `max_memory_allocated`, the adjoint CG iterations. Gates: a finite,
    non-zero gradient; K6ᵀ (K7ᵀ) launched once for each K6 (K7) launch of
    the forward; a directional finite difference, (L(v+εd) − L(v−εd))/2ε
    against ⟨∇L, d⟩ within 5% (d a smooth seeded direction); 3
    gradient-descent iterations on the initial velocity lowering L each.
    Printed, not gated: whether the gradient repeats bit for bit from the
    same state. With `ch`, K6ᵀ / K7ᵀ checked and timed on the inputs a
    differentiated step gives them (`time_grad_path_inputs`).
    `period`: the state's, weight's and direction's waves repeat every so
    many cells (`smooth_state`). At 4096² a wave across the whole grid gives
    a pressure N² times its divergence, beyond what float32 CG resolves to
    cg_tol (300 iterations unconverged); waves of 256 cells keep the 256³
    path's ratio."""
    import numpy as np
    import torch
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.models import SmokePlume, state_from_numpy
    from phiflow_tpu_torch.ops import _build
    model = SmokePlume(resolution=N, dims=dims, cg_tol=cg_tol, max_iterations=300, device='cuda')
    vel, smoke, _ = state_from_numpy(*smooth_state(N, dims, period=period), device='cuda')
    w = _smooth_weight(N, dims, period).cuda()
    _smoke_grad(model, (vel, smoke), w, steps)  # warm-up: the kernels' first launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # what earlier phases and the state hold: not this call's peak
    record = {}
    _build.reset_launches()
    with math.SolveTape() as tape:
        t0 = time.perf_counter()
        value, gvel, gsmoke = _smoke_grad(model, (vel, smoke), w, steps, record)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    backward = dict(_build.LAUNCHES)
    forward = record['forward']
    memory = torch.cuda.max_memory_allocated() - base
    fwd_iters = [i.iterations for i in tape if not i.msg.startswith('adjoint')]
    adj_iters = [i.iterations for i in tape if i.msg.startswith('adjoint')]
    fwd_ms = (record['forward_end'] - t0) / steps * 1e3
    total_ms = (t1 - t0) / steps * 1e3
    k6 = f'window_interp_{dims}d'
    print(f'{tag} {N}^{dims}: {steps} steps of the Field step under grad, math.gradient of sum(w * smoke) + '
          f'sum(w[1:] * v_x) w.r.t. '
          f'the initial velocity and smoke: forward {fwd_ms:.2f} ms/step, forward + backward {total_ms:.2f} '
          f'ms/step; max_memory_allocated {memory / 2 ** 30:.2f} GiB above the {base / 2 ** 30:.2f} GiB allocated '
          f'before (after the forward {(record["memory_forward"] - base) / 2 ** 30:.2f} GiB); CG iterations forward '
          f'{fwd_iters}, adjoint {adj_iters}')
    print(f'{tag} launches, forward: ' + ', '.join(f'{k}={forward.get(k, 0)}' for k in KERNELS))
    print(f'{tag} launches, backward (adjoint solves and K6T/K7T): '
          + ', '.join(f'{k}={backward.get(k, 0)}' for k in KERNELS))
    grads = gvel + [gsmoke]
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    scale = max(float(g.abs().max()) for g in grads)
    cg = ['poisson_stencil', 'jacobi_sweeps', 'residual_restrict', 'prolong_add'] if dims == 3 else []
    missing = ([f'{k} (forward)' for k in [k6] + cg if not forward.get(k, 0)]
               + [f'{k} (backward)' for k in [k6 + '_grad'] + cg if not backward.get(k, 0)])
    wrong = {}
    if backward.get(k6 + '_grad', 0) != forward.get(k6, 0):
        wrong[k6 + '_grad'] = (backward.get(k6 + '_grad', 0), forward.get(k6, 0))
    if forward.get('fused_advect', 0) + backward.get('fused_advect', 0):
        wrong['fused_advect'] = (forward.get('fused_advect', 0) + backward.get('fused_advect', 0), 0)
    if not (finite and scale > 0) or wrong or missing or len(adj_iters) != steps:
        raise RuntimeError(f'{tag}: gradient finite={finite} scale={scale}, launches (counted, expected) {wrong}, '
                           f'not launched {missing}, adjoint solves {adj_iters}')
    # the same gradient again from the same state: whether it repeats bit for bit (printed, not gated)
    again_value, again_vel, again_smoke = _smoke_grad(model, (vel, smoke), w, steps)
    names = [f'd/dv[{i}]' for i in range(dims)] + ['d/dsmoke']
    same = [bool(torch.equal(a, b)) for a, b in zip(grads, again_vel + [again_smoke])]
    print(f'{tag} repeat from the same state: L {"bit-equal" if again_value == value else f"{value!r} vs {again_value!r}"}'
          f', gradients ' + ', '.join(f'{n} {"bit-equal" if s else f"max |diff| {float((a - b).abs().max()):.3e}"}'
                                      for n, s, a, b in zip(names, same, grads, again_vel + [again_smoke])))
    del again_vel, again_smoke
    # the directional finite difference along a smooth seeded direction
    direction = [torch.from_numpy(a).cuda() for a in smooth_state(N, dims, seed=5, period=period)[:dims]]
    eps = 1e-2
    plus = _forward_loss(model, ([v + eps * d for v, d in zip(vel, direction)], smoke), w, steps)
    minus = _forward_loss(model, ([v - eps * d for v, d in zip(vel, direction)], smoke), w, steps)
    fd = (plus - minus) / (2 * eps)
    dot = float(sum((g.double() * d.double()).sum() for g, d in zip(gvel, direction)))
    fd_ok = abs(fd - dot) <= 0.05 * abs(dot)
    print(f'{tag} directional check, eps {eps}: (L(v+eps d) - L(v-eps d)) / 2 eps = {fd:.6e}, <grad L, d> = '
          f'{dot:.6e}, relative difference {abs(fd - dot) / abs(dot):.2e} (tol 5e-02): {"ok" if fd_ok else "FAIL"}')
    # gradient descent on the initial velocity
    losses, v_k, g_k = [value], list(vel), gvel
    eta = 0.02 * max(float(v.abs().max()) for v in vel)
    for _ in range(3):
        g_max = max(float(g.abs().max()) for g in g_k)
        v_k = [v - (eta / g_max) * g for v, g in zip(v_k, g_k)]
        value, g_k, _ = _smoke_grad(model, (v_k, smoke), w, steps)
        losses.append(value)
    falling = all(b < a for a, b in zip(losses, losses[1:]))
    print(f'{tag} gradient descent on the initial velocity, 3 iterations of step {eta:.3f} / max|grad|: L '
          + ' -> '.join(f'{x:.6e}' for x in losses) + f': {"falling" if falling else "NOT falling (FAIL)"}')
    if not (fd_ok and falling):
        raise RuntimeError(f'{tag}: finite-difference check {fd} vs {dot}, losses {losses}')
    counts = {k: forward.get(k, 0) + backward.get(k, 0) for k in KERNELS}
    if ch is not None:
        time_grad_path_inputs(ch, tag, dims, model, (vel, smoke), w)
    return dict(counts, steps=steps)


def _keep_grad_calls(name, args, kwargs, kept):
    """`Recorder`'s keep for a differentiated step: the first K6ᵀ / K7ᵀ call of each halo form with and without
    the extrema (its arguments and the forward's word it was given, the tensors copied)."""
    grid, disps, K, extrema, scale, mode, const, grads, need_grid, need_disp = args[1:]
    if (mode, bool(extrema)) in kept:
        return {}
    word = kwargs.get('verdict')
    return {(mode, bool(extrema)): ((grid.clone(), [x.clone() for x in disps], K, extrema, scale, mode, const,
                                     [None if g is None else g.clone() for g in grads], need_grid, need_disp),
                                    None if word is None else word.clone())}


def time_grad_path_inputs(ch, tag, dims, model, state, w):
    """K6ᵀ / K7ᵀ on the inputs one more differentiated step of `tag` gives
    them (`Recorder` with `_keep_grad_calls`): the first call of each halo
    form with and without the extrema, with the forward's word the step
    gave it (the instantiation autograd launches; a call given none is
    replayed bare), against the twin's VJP, then timed as phase 3's rows
    are (the library's `grid_sample` where the grid is raw and its halo
    constant 0 or clamped), kept in the kernel's row as its parts. The
    gate: each form was given the forward's word. d_grid within GRAD_TOL of
    its largest entry; d_disp within
    GRAD_TOL of its largest term, max |g| · |scale| · max |grid| (the
    d_disp of a unit step): on smooth fields d_disp is a difference of
    neighbouring grid values, which the twin forms by summing the window's
    taps in float32, so its rounding is that of the taps, not of the result
    (a float64 twin meets other kinks: float32 rounds 1 − |d − s| to 0 at
    taps that float64 does not)."""
    from phiflow_tpu_torch.ops import interp as I
    name = GRAD_NAMES[dims]
    with Recorder(_keep_grad_calls, _window_interp_grad_cuda=I) as rec:
        _smoke_grad(model, state, w, 1)
    keys = []
    for (mode, extrema), (args, word) in rec.kept.items():
        grid, disps, K, _, scale, _, const, grads, need_grid, need_disp = args
        ups = [g for g in grads if g is not None]
        what = (f'{tag} path inputs, {tuple(disps[0].shape)} K={K} {mode or "padded"}{" extrema" if extrema else ""}'
                f'{"" if need_grid else ", d_disp only"}{", bare" if word is None else ""}')
        if word is None:
            print(f'check {name:17s} {what}: the step gave K6T / K7T no forward\'s word FAIL')
            ch.failed.append(f'{name} {what}: no forward\'s word')
        kw = {} if word is None else dict(verdict=word)
        got = I._window_interp_grad_cuda(f'window_interp_{dims}d', *args, **kw)
        ref = I._window_interp_vjp_plain(*args)
        if got[0] is not None:
            ch.compare(name, f'{what} d_grid', got[0], ref[0], GRAD_TOL * max(float(ref[0].abs().max()), 1e-30))
        step = float(ups[0].abs().max()) * max(float(grid.abs().max()), abs(const)) if ups and grads[0] is not None \
            else 0.0
        for i, (g, r) in enumerate(zip(got[1], ref[1])):
            if g is not None:
                term = step * abs(scale[i])
                ch.compare(name, f'{what} d_disp[{i}] (term {term:.2e})', g, r,
                           GRAD_TOL * max(float(r.abs().max()), term, 1e-30))
        del got, ref
        n = disps[0].numel()
        ops = (2 ** dims * (dims * dims + dims + 1) + 32 * dims) * n + (2 ** (dims + 2) * n if extrema else 0)
        outs = ([grid] if need_grid else []) + (list(disps) if need_disp else [])
        raw = mode in ('edge', 'const') and tuple(grid.shape) == tuple(disps[0].shape) and const == 0.0
        lib = (_grid_sample_backward(grid, disps, K, scale, 'border' if mode == 'edge' else 'zeros', ups[0])
               if raw and ups else None)
        key = f'{name} {tag} {mode or "padded"}{" +extrema" if extrema else ""}'
        ch.time(name, what, lambda: I._window_interp_grad_cuda(f'window_interp_{dims}d', *args, **kw),
                lambda: I._window_interp_vjp_plain(*args), nbytes(grid, *disps, *ups) + nbytes(*outs), ops, lib,
                key=key)
        keys.append(key)
        del lib
    ch.attach(name, keys)
    del rec


def profile_gradient(tag, dims, N, steps, period=None, cg_tol=GRAD_CG_TOL):
    """`run_gradient_path`'s `math.gradient` of `steps` Field steps under
    torch.profiler, a call at a time (1 warm-up, 2 profiled): device time by
    kernel a call, the busy share."""
    from phiflow_tpu_torch.models import SmokePlume, state_from_numpy
    model = SmokePlume(resolution=N, dims=dims, cg_tol=cg_tol, max_iterations=300, device='cuda')
    vel, smoke, _ = state_from_numpy(*smooth_state(N, dims, period=period), device='cuda')
    w = _smooth_weight(N, dims, period).cuda()
    profile_path(f'{tag} forward + backward ({steps} steps a call: "step" below is a call)', f'{N}^{dims}',
                 lambda state: (_smoke_grad(model, state, w, steps), state)[1], (vel, smoke), warmup=1, steps=2,
                 rows_shown=14)


def gradient_cpu_vs_card(dims, N, steps=2, tol=1e-3):
    """The same rollout gradient from one numpy state on the CPU (the twins
    and their VJPs) and on the card (the kernels and K6ᵀ / K7ᵀ): within 1e-3
    of the gradient's largest entry."""
    import numpy as np
    import torch
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.models import SmokePlume, state_from_numpy
    arrays = smooth_state(N, dims)
    w = _smooth_weight(N, dims)
    out = {}
    for dev in ('cpu', 'cuda'):
        with math.default_device(dev):
            model = SmokePlume(resolution=N, dims=dims, cg_tol=GRAD_CG_TOL, max_iterations=300, device=dev)
            vel, smoke, _ = state_from_numpy(*arrays, device=dev)
            _, gvel, gsmoke = _smoke_grad(model, (vel, smoke), w.to(dev), steps)
            out[dev] = [g.detach().cpu().numpy() for g in (*gvel, gsmoke)]
    scale = max(float(np.abs(g).max()) for g in out['cpu'])
    errs = [float(np.abs(a - b).max()) for a, b in zip(out['cpu'], out['cuda'])]
    ok = max(errs) <= tol * scale
    print(f'cpu vs card, gradient of {steps} steps at {N}^{dims}: max |cpu - card| '
          + ', '.join(f'{e:.2e}' for e in errs) + f' of scale {scale:.3e}, tol {tol:.0e} of scale: '
          + ('ok' if ok else 'FAIL'))
    if not ok:
        raise RuntimeError(f'gradients on the CPU and the card disagree at {N}^{dims}: {errs}, scale {scale}')


def gradient_kernel_vs_twin(dims, N, steps=1, tol=1e-3, max_cells=8):
    """SmokePlume(N, dims, max_cells)'s rollout gradient on the card from one
    numpy state twice: through K6ᵀ / K7ᵀ (at max_cells=8 in 3D the wide
    kernel, launched at least once) and with the twin's VJP in their place
    (`_window_interp_vjp_plain` on the card, which the CPU would take hours
    for at (2K + 1)^D taps): within 1e-3 of the gradient's largest entry,
    `gradient_cpu_vs_card`'s gate."""
    import numpy as np
    from phiflow_tpu_torch.models import SmokePlume, state_from_numpy
    from phiflow_tpu_torch.ops import _build
    from phiflow_tpu_torch.ops import interp as I
    arrays = smooth_state(N, dims)
    w = _smooth_weight(N, dims).cuda()
    k6t = f'window_interp_{dims}d_grad'
    out, kernel = {}, I._window_interp_grad_cuda
    before = _build.LAUNCHES[k6t]
    for route in ('kernel', 'twin'):
        model = SmokePlume(resolution=N, dims=dims, cg_tol=GRAD_CG_TOL, max_iterations=300, device='cuda',
                           max_cells=max_cells)
        vel, smoke, _ = state_from_numpy(*arrays, device='cuda')
        if route == 'twin':
            launched = _build.LAUNCHES[k6t] - before
            I._window_interp_grad_cuda = lambda name, *args, verdict=None: I._window_interp_vjp_plain(*args)
        try:
            _, gvel, gsmoke = _smoke_grad(model, (vel, smoke), w, steps)
        finally:
            I._window_interp_grad_cuda = kernel
        out[route] = [g.detach().cpu().numpy() for g in (*gvel, gsmoke)]
    scale = max(float(np.abs(g).max()) for g in out['twin'])
    errs = [float(np.abs(a - b).max()) for a, b in zip(out['twin'], out['kernel'])]
    ok = max(errs) <= tol * scale and launched > 0
    print(f'kernel vs twin on the card, gradient of {steps} steps at {N}^{dims}, max_cells={max_cells} ({k6t} '
          f'{launched} launches): max |twin - kernel| ' + ', '.join(f'{e:.2e}' for e in errs)
          + f' of scale {scale:.3e}, tol {tol:.0e} of scale: ' + ('ok' if ok else 'FAIL'))
    if not ok:
        raise RuntimeError(f'max_cells={max_cells}: the gradient through {k6t} and through its twin disagree at '
                           f'{N}^{dims}: {errs}, scale {scale}, {launched} launches')

def run_network_training(N=64, steps=5):
    """nn.conv_net(3, 3, [16, 16], in_spatial=3) at N³ predicts a velocity
    correction from three smooth fields; the corrected velocity goes through
    `fluid.make_incompressible` (K1–K4, and their adjoint in the backward);
    the loss is its mean squared distance to a divergence-free target. Gate:
    `steps` `nn.update_weights` Adam steps lower the loss."""
    import numpy as np
    import torch
    from phiflow_tpu_torch import math, nn
    from phiflow_tpu_torch.ops import _build
    from phiflow_tpu_torch.physics import fluid
    from phiflow_tpu_torch.field import CenteredGrid, StaggeredGrid
    from phiflow_tpu_torch.geom import Box
    arrays = smooth_state(N, 3, seed=21)
    target_arrays = smooth_state(N, 3, seed=22)
    names = ('x', 'y', 'z')
    bounds = Box(x=float(N), y=float(N), z=float(N))

    def staggered(comps):
        return StaggeredGrid(math.stack([math.wrap(c, math.spatial(*names)) for c in comps], math.dual(vector=names)),
                             0., bounds=bounds, x=N, y=N, z=N)

    solve = math.Solve('CG', GRAD_CG_TOL, 0., max_iterations=300)
    target, _ = fluid.make_incompressible(staggered([torch.from_numpy(a).cuda() for a in target_arrays[:3]]), (),
                                          solve)
    target = [c.torch(names) for c in _faces_of(target)]
    v0 = [torch.from_numpy(a).cuda() for a in arrays[:3]]
    features = torch.from_numpy(np.stack([smooth_state(N, 3, seed=k)[3] for k in (23, 24, 25)], -1)[None]).cuda()
    torch.manual_seed(0)
    with math.default_device('cuda'):
        net = nn.conv_net(3, 3, [16, 16], in_spatial=3)
    opt = nn.adam(net, 1e-3)

    def loss():
        out = net(features)[0]
        corr = [out[:N - 1, :, :, 0], out[:, :N - 1, :, 1], out[:, :, :N - 1, 2]]
        v, _ = fluid.make_incompressible(staggered([a + b for a, b in zip(v0, corr)]), (), solve)
        return sum(((c.torch(names) - t) ** 2).mean() for c, t in zip(_faces_of(v), target))

    _build.reset_launches()
    t0 = time.perf_counter()
    losses = [float(nn.update_weights(net, opt, loss)) for _ in range(steps)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    launches = dict(_build.LAUNCHES)
    falling = losses[-1] < losses[0]
    print(f'network {N}^3: conv_net(3, 3, [16, 16]), {nn.parameter_count(net)} parameters, {steps} Adam steps '
          f'through make_incompressible, {ms:.1f} ms a step: loss ' + ' -> '.join(f'{x:.6e}' for x in losses)
          + f'; launches ' + ', '.join(f'{k}={launches.get(k, 0)}' for k in CG_KERNELS if launches.get(k, 0))
          + f': {"falling" if falling else "NOT falling (FAIL)"}')
    if not falling or not launches.get('poisson_stencil', 0):
        raise RuntimeError(f'network through the projection: losses {losses}, launches {launches}')


def _faces_of(velocity):
    from phiflow_tpu_torch.field._field import face_components
    return face_components(velocity.values)


def check_guards(N=64):
    """K5 has no backward: on the card `fused_advect_3d` raises on an input
    that requires grad under grad mode; the same step under `no_grad`
    launches K5 three times, and under grad takes the per-phase path (K6
    five times, K5 never)."""
    import torch
    from phiflow_tpu_torch.models import SmokePlume, state_from_numpy
    from phiflow_tpu_torch.ops import _build
    model = SmokePlume(resolution=N, dims=3, cg_tol=1e-3, max_iterations=100, device='cuda')
    vel, smoke, pressure = state_from_numpy(*smooth_state(N), device='cuda')
    leaves = tuple(v.clone().requires_grad_() for v in vel)
    try:
        model._fused_advect_native(leaves, smoke)
        raised = None
    except RuntimeError as e:
        raised = str(e)
    _build.reset_launches()
    with torch.no_grad():
        model.step_native(leaves, smoke, pressure)
    torch.cuda.synchronize()
    no_grad = dict(_build.LAUNCHES)
    _build.reset_launches()
    model.step_native(leaves, smoke, pressure)
    torch.cuda.synchronize()
    with_grad = dict(_build.LAUNCHES)
    ok = (raised is not None and 'no backward' in raised and no_grad.get('fused_advect', 0) == FUSED_CALLS_PER_STEP
          and not no_grad.get('window_interp_3d', 0) and not with_grad.get('fused_advect', 0)
          and with_grad.get('window_interp_3d', 0) == K6_LAUNCHES_PER_PHASE_STEP)
    print(f'guards {N}^3: fused_advect_3d on a requires-grad input under grad mode raised: {raised is not None} '
          f'({(raised or "")[:60]}...); the step under no_grad: fused_advect={no_grad.get("fused_advect", 0)}, '
          f'window_interp_3d={no_grad.get("window_interp_3d", 0)}; under grad: fused_advect='
          f'{with_grad.get("fused_advect", 0)}, window_interp_3d={with_grad.get("window_interp_3d", 0)}: '
          + ('ok' if ok else 'FAIL'))
    if not ok:
        raise RuntimeError(f'guards: raised={raised}, no_grad {no_grad}, grad {with_grad}')


def run_gradients(ch):
    """Phase 6's paths: the differentiated rollouts at full width (256³, 3
    steps; 4096², 2 steps) with K6ᵀ / K7ᵀ timed on their inputs, CPU against
    card at 32³ and 128², max_cells=8 at 32³ against the twin, the network trained
    through the projection, the guards, then the CG dot probe (last: its
    model's memory stays out of the paths' peaks)."""
    import torch
    part = PhaseClock('part of phase')
    by_path = {'grad-256': run_gradient_path('grad-256', 3, PATH_N, 3, ch=ch)}
    torch.cuda.empty_cache()
    by_path['grad-4096-2d'] = run_gradient_path('grad-4096-2d', 2, PATH_N_2D, 2, period=PATH_N,
                                                cg_tol=GRAD_CG_TOL_4096, ch=ch)
    torch.cuda.empty_cache()
    part.done('6 grad-256 and grad-4096-2d')
    gradient_cpu_vs_card(3, 32, steps=1)
    gradient_cpu_vs_card(2, 128)
    gradient_kernel_vs_twin(3, 32, max_cells=8)
    part.done('6 CPU against card')
    run_network_training()
    check_guards()
    part.done('6 network and guards')
    cg_dot_probe()
    torch.cuda.empty_cache()
    part.done('6 CG dot probe')
    return by_path


# ---------------------------------------------------------------------------
# phase 7: optimisation (math.minimize through the differentiable paths) and the new grid names
# ---------------------------------------------------------------------------

PIV_N, PIV_MARKERS, PIV_BOX = 64, 1024, 20.  # examples/piv.py's configuration
PIV_ITERATIONS = 100
OPT_CHECK_ITERATIONS = 3   # L-BFGS iterations held card against CPU from one numpy state
OPT_TOL = 1e-4             # of each quantity's scale: float32 line searches on two devices
PIV_WITNESS_TOL = 1e-6     # the same iterations in float64
PIV_NUDGE = 1e-7           # a relative change of the full fit's start, about one float32 rounding
INVERSE_STEPS, INVERSE_ITERATIONS = 2, 3
GRID_NAMES_TOL, FFT_TOL = 1e-5, 1e-4
# JAX's rule takes its slab route at 256³ for no point count (the table of 258³ · 4 entries exceeds its 64 Mi):
# the slab route is forced, CPU against card at 2^16 points, against the per-corner route on the card at 2^20
SAMPLE_POINTS, SLAB_POINTS = 2 ** 20, 2 ** 16
HISTOGRAM_VALUES = 2 ** 24


def _scale_err(got, ref):
    """max |got − ref| / max |ref| of two tensors, on the host."""
    got, ref = got.detach().cpu().double(), ref.detach().cpu().double()
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


def _piv_state(seed=2):
    """examples/piv.py's velocity and markers from a numpy seed: smooth
    noise on the 64² closed box (white noise under a Gaussian filter of 8
    cells), projected to zero divergence on the CPU, and 1024 markers
    uniform in the box. Returns the projected face arrays and the markers."""
    import numpy as np
    import torch
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.field import StaggeredGrid
    from phiflow_tpu_torch.geom import Box
    from phiflow_tpu_torch.physics import fluid
    rng = np.random.default_rng(seed)
    n = PIV_N
    k = np.fft.fftfreq(n + 1)
    filt = np.exp(-0.5 * (k[:, None] ** 2 + k[None, :] ** 2) * (8 * 2 * np.pi) ** 2)
    comps = []
    for shape in ((n - 1, n), (n, n - 1)):
        smooth = np.real(np.fft.ifft2(np.fft.fft2(rng.standard_normal((n + 1, n + 1))) * filt))[:shape[0], :shape[1]]
        comps.append((smooth / np.abs(smooth).max()).astype(np.float32))
    with math.default_device('cpu'):
        v0 = StaggeredGrid(math.stack([math.wrap(torch.from_numpy(c), math.spatial('x,y')) for c in comps],
                                      math.dual(vector='x,y')), 0, Box(x=PIV_BOX, y=PIV_BOX), x=n, y=n)
        v0, _ = fluid.make_incompressible(v0)
        comps = [v0.values[{'~vector': d}].numpy(('x', 'y')) for d in 'xy']
    return comps, rng.uniform(0, PIV_BOX, (PIV_MARKERS, 2)).astype(np.float32)


def _piv_fits(device, comps, markers_np, iterations, record=None, fit1_comps=None, bits=32):
    """examples/piv.py on `device` from the numpy state: the coarse L-BFGS
    fit on `0 * v0.downsample(4)`, then the full-resolution fit, each of at
    most `iterations` (abs_tol 1e-6); `fit1_comps` (numpy face arrays at
    64²) replaces the coarse fit's result before the second. `bits` is the
    float width of the state and of every value made (`math.precision`).
    Returns (v0, fit1 at 64², fit2, the final markers, the marker loss of
    the estimate). With `record` (a dict), the fits' iterations,
    evaluations, wall ms and syncs go there."""
    import warnings
    import torch
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.field import StaggeredGrid, resample
    from phiflow_tpu_torch.geom import Box
    from phiflow_tpu_torch.math import Solve, channel, instance
    from phiflow_tpu_torch.math._optimize import optimizer_trace
    from phiflow_tpu_torch.physics import advect
    dtype = torch.float64 if bits == 64 else torch.float32

    def faces(arrays):
        return math.stack([math.wrap(torch.from_numpy(c).to(device, dtype), math.spatial('x,y')) for c in arrays],
                          math.dual(vector='x,y'))
    with math.default_device(device), math.precision(bits):
        n = PIV_N
        v0 = StaggeredGrid(faces(comps), 0, Box(x=PIV_BOX, y=PIV_BOX), x=n, y=n)
        markers = math.wrap(torch.from_numpy(markers_np).to(device, dtype), instance('markers'), channel(vector='x,y'))

        @math.jit_compile
        def simulate(v):
            return advect.points(markers, v, dt=.1, integrator=advect.rk4)

        final = simulate(v0)

        def fit(loss, x0, name):
            solve = Solve('L-BFGS-B', abs_tol=1e-6, x0=x0, max_iterations=iterations)
            if record is None:
                return math.minimize(loss, solve)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with optimizer_trace() as trace, warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter('always')
                torch.cuda.set_sync_debug_mode('warn')
                try:
                    x = math.minimize(loss, solve)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            syncs = [w for w in caught if 'synchronizing' in str(w.message) and not w.filename.endswith('cuda/__init__.py')]
            record[name] = dict(iterations=len(trace), ms=(time.perf_counter() - t0) * 1e3, syncs=len(syncs),
                                evaluations=sum(e['evaluations'] for e in trace) + 1, loss=[e['loss'] for e in trace])
            return x

        fit1 = resample(fit(lambda x: math.l2_loss(final - simulate(resample(x, to=v0))), 0 * v0.downsample(4), 'fit1'),
                        to=v0)
        base = fit1 if fit1_comps is None else v0.with_values(faces(fit1_comps))
        fit2 = fit(lambda x: math.l2_loss(final - simulate(x + base)), 0 * v0, 'fit2')
        return v0, fit1, fit2, final, float(math.l2_loss(final - simulate(base + fit2)))


def _piv_card_vs_cpu(comps, markers, bits):
    """The first OPT_CHECK_ITERATIONS L-BFGS iterations of both fits at
    `bits`, on the CPU and on the card from one numpy state, the card's
    full fit from the CPU's coarse result. Returns the scale errors of
    fit1, the final markers, fit2 and the marker loss, and each device's
    (loss, step) an iteration."""
    import numpy as np
    from phiflow_tpu_torch.math._optimize import optimizer_trace
    dtype = np.float64 if bits == 64 else np.float32
    comps, markers = [c.astype(dtype) for c in comps], markers.astype(dtype)
    short, traces = {}, {}
    for dev in ('cpu', 'cuda'):
        fit1_comps = None if dev == 'cpu' else [short['cpu'][1].values[{'~vector': d}].numpy(('x', 'y'))
                                               for d in 'xy']
        with optimizer_trace() as traces[dev]:
            short[dev] = _piv_fits(dev, comps, markers, OPT_CHECK_ITERATIONS, fit1_comps=fit1_comps, bits=bits)
    errs = {
        'fit1 (at 64^2)': max(_scale_err(c.torch(), r.torch()) for c, r in zip(short['cuda'][1].values.components,
                                                                              short['cpu'][1].values.components)),
        'final markers': _scale_err(short['cuda'][3].torch(), short['cpu'][3].torch()),
        'fit2': max(_scale_err(c.torch(), r.torch()) for c, r in zip(short['cuda'][2].values.components,
                                                                    short['cpu'][2].values.components)),
        'marker loss': abs(short['cuda'][4] - short['cpu'][4]) / abs(short['cpu'][4])}
    return errs, {dev: [(e['loss'], e['step']) for e in trace] for dev, trace in traces.items()}


def run_piv():
    """examples/piv.py on the card. Card against CPU from one numpy state,
    the first 3 L-BFGS iterations of each fit (the full fit from the CPU's
    coarse result): in float32 the coarse fit and the markers gated at
    OPT_TOL, the full fit printed (its loss of ≈ 2e-3 leaves the float32
    line searches' comparisons within rounding of each other, and the
    iterates further apart than OPT_TOL); in float64 all four gated at
    PIV_WITNESS_TOL, the witness that the float32 gap is rounding; on the
    CPU alone, how far a PIV_NUDGE change of its start moves the float32
    full fit (printed). Then
    both fits of 100 iterations in float32 on the card, gated on the
    example's own assert."""
    import torch
    from phiflow_tpu_torch import math
    comps, markers = _piv_state()
    checks = {bits: _piv_card_vs_cpu(comps, markers, bits) for bits in (32, 64)}
    errs32, errs64 = checks[32][0], checks[64][0]
    gated = {f'float32 {k}': errs32[k] for k in ('fit1 (at 64^2)', 'final markers')}
    witness = {f'float64 {k}': v for k, v in errs64.items()}
    print(f'piv {PIV_N}^2, {PIV_MARKERS} markers: card vs CPU, the first {OPT_CHECK_ITERATIONS} L-BFGS iterations '
          f'of each fit from one numpy state: gated at {OPT_TOL:.0e} of scale: '
          + ', '.join(f'{k} {v:.2e}' for k, v in gated.items())
          + '; printed: ' + ', '.join(f'float32 {k} {errs32[k]:.2e}' for k in ('fit2', 'marker loss'))
          + f'; gated at {PIV_WITNESS_TOL:.0e}: ' + ', '.join(f'{k} {v:.2e}' for k, v in witness.items()))
    start = _piv_fits('cpu', comps, markers, OPT_CHECK_ITERATIONS)
    fit1 = [start[1].values[{'~vector': d}].numpy(('x', 'y')) for d in 'xy']
    nudged = _piv_fits('cpu', comps, markers, OPT_CHECK_ITERATIONS,
                       fit1_comps=[(c * (1 + PIV_NUDGE)).astype(c.dtype) for c in fit1])
    moved = max(_scale_err(c.torch(), r.torch()) for c, r in zip(nudged[2].values.components,
                                                                 start[2].values.components))
    print(f'piv {PIV_N}^2 float32 on the CPU alone: the full fit\'s first {OPT_CHECK_ITERATIONS} iterations moved by '
          f'{moved:.2e} of scale when their start is scaled by 1 + {PIV_NUDGE:.0e} (printed)')
    for bits, (_, traces) in checks.items():
        for dev, trace in traces.items():
            print(f'piv {PIV_N}^2 float{bits} on {dev}: (loss, step) an iteration, coarse then full: '
                  + ', '.join(f'({loss:.9e}, {step:.6g})' for loss, step in trace))
    if not (all(v <= OPT_TOL for v in gated.values()) and all(v <= PIV_WITNESS_TOL for v in witness.values())):
        raise RuntimeError(f'piv card vs CPU: {gated}, {witness}')
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    record = {}
    v0, fit1, fit2, final, marker_loss = _piv_fits('cuda', comps, markers, PIV_ITERATIONS, record)
    memory = torch.cuda.max_memory_allocated() - base
    with math.default_device('cuda'):
        err0 = float(math.l2_loss(v0))
        err = float(math.l2_loss(fit1 + fit2 - v0))
    for name, r in record.items():
        it = max(r['iterations'], 1)
        print(f'piv {PIV_N}^2 {name}: {r["iterations"]} L-BFGS iterations, {r["ms"] / it:.2f} ms an iteration, '
              f'{r["evaluations"] / it:.2f} loss evaluations an iteration, {r["syncs"] / it:.1f} host syncs an '
              f'iteration (set_sync_debug_mode), loss {r["loss"][0]:.6e} -> {r["loss"][-1]:.6e}')
    ok = err < 0.5 * err0
    print(f'piv {PIV_N}^2: velocity error {err:.5f} of field magnitude {err0:.3f} (the example asserts < 0.5 x), '
          f'marker residual {marker_loss:.3e}; max_memory_allocated {memory / 2 ** 20:.1f} MiB above the '
          f'{base / 2 ** 20:.1f} MiB allocated at the start: '
          f'{"ok" if ok else "FAIL"}')
    if not ok:
        raise RuntimeError(f'piv: error {err} vs {err0}')


def run_inverse_smoke(N=PATH_N, steps=INVERSE_STEPS, iterations=INVERSE_ITERATIONS):
    """math.minimize with L-BFGS over the initial smoke CenteredGrid of
    SmokePlume(N, dims=3): the target is the smoke after `steps` Field steps
    from `smooth_state(N)`'s smoke, the start a constant 0.5, the loss
    l2_loss of the difference. Under grad the step takes the per-phase path
    (K6, K6ᵀ in the backward) and each projection and its adjoint K1–K4. Per
    iteration: the loss, the launches, the forward and adjoint CG
    iterations, ms, `max_memory_allocated` (the SolveTape kept whole, as a
    user's: it holds each solve's x). Gates: the loss falls every
    iteration, finite; K6, K6ᵀ and K1–K4 launched."""
    import numpy as np
    import torch
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.math._optimize import optimizer_trace
    from phiflow_tpu_torch.models import SmokePlume, state_from_numpy
    from phiflow_tpu_torch.ops import _build
    model = SmokePlume(resolution=N, dims=3, cg_tol=GRAD_CG_TOL, max_iterations=300, device='cuda')
    vel, smoke, _ = state_from_numpy(*smooth_state(N), device='cuda')
    with math.default_device('cuda'):
        v, s_true, _ = model.state_fields(vel, smoke, None)
        with torch.no_grad():
            vt, target, p = v, s_true, None
            for _ in range(steps):
                vt, target, p = model.step(vt, target, p)
        evaluations = []

        def loss(s):
            vk, sk, pk = v, s, None
            for _ in range(steps):
                vk, sk, pk = model.step(vk, sk, pk)
            value = math.l2_loss(sk - target)
            evaluations.append(math.stop_gradient(value))  # the loss alone: a kept graph would hold its tensors
            return value

        x0 = s_true * 0 + 0.5
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rows, mark = [], {}

        def on_iteration(entry):
            torch.cuda.synchronize()
            now, launches = time.perf_counter(), dict(_build.LAUNCHES)
            solves = tape.solve_infos[mark['solves']:]
            rows.append(dict(entry, ms=(now - mark['t']) * 1e3, memory=torch.cuda.max_memory_allocated() - base,
                             launches={k: launches.get(k, 0) - mark['launches'].get(k, 0) for k in KERNELS},
                             forward=[i.iterations for i in solves if not i.msg.startswith('adjoint')],
                             adjoint=[i.iterations for i in solves if i.msg.startswith('adjoint')]))
            mark.update(t=now, launches=launches, solves=len(tape.solve_infos))

        base = torch.cuda.memory_allocated()
        _build.reset_launches()
        with math.SolveTape() as tape, optimizer_trace(on_iteration):
            mark.update(t=time.perf_counter(), launches={}, solves=0)
            math.minimize(loss, math.Solve('L-BFGS-B', abs_tol=1e-12, x0=x0, max_iterations=iterations))
        counts = dict(_build.LAUNCHES)
    l0 = float(evaluations[0])
    losses = [l0] + [r['loss'] for r in rows]
    for k, r in enumerate(rows):
        print(f'inverse-smoke-{N} iteration {k + 1}: loss {r["loss"]:.6e} (step {r["step"]:.3g}, {r["evaluations"]} '
              f'loss evaluations), {r["ms"]:.1f} ms, max_memory_allocated {r["memory"] / 2 ** 30:.2f} GiB above the '
              f'{base / 2 ** 30:.2f} GiB allocated at the start, CG '
              f'iterations forward {r["forward"]} adjoint {r["adjoint"]}; launches '
              + ', '.join(f'{k}={r["launches"][k]}' for k in ('window_interp_3d', 'window_interp_3d_grad')
                          + PHASES_3D_KERNELS[:4]))
    falling = all(b < a for a, b in zip(losses, losses[1:])) and all(np.isfinite(losses))
    needed = ('window_interp_3d', 'window_interp_3d_grad') + PHASES_3D_KERNELS[:4]
    missing = [k for k in needed if not counts.get(k, 0)]
    print(f'inverse-smoke-{N}: L-BFGS over the initial smoke, {steps} Field steps a loss, the loss '
          + ' -> '.join(f'{x:.6e}' for x in losses) + f': {"falling" if falling else "NOT falling (FAIL)"}; '
          f'K5 launches {counts.get("fused_advect", 0)}; not launched: {missing or "none"}')
    if not falling or missing or counts.get('fused_advect', 0) or len(rows) != iterations:
        raise RuntimeError(f'inverse-smoke-{N}: losses {losses}, not launched {missing}, {len(rows)} iterations')
    return dict(counts, steps=len(evaluations))


def run_close_packing(device='cuda', iterations=500):
    """examples/close_packing.py as it stands, on `device`: 32 spheres of
    radius 1 and 32 of 0.5 in a periodic box, the pairwise overlap penalty
    minimised by L-BFGS from numpy's RandomState(0); gated on its assert."""
    import numpy as np
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.math import Solve, channel, instance, wrap
    with math.default_device(device):
        radii = np.concatenate([np.ones(32, np.float32), np.full(32, 0.5, np.float32)])
        R = wrap(radii, instance('spheres'))
        size = float(np.sqrt(np.sum(np.pi * radii ** 2) * 1.05))
        rng = np.random.RandomState(0)
        x0 = wrap(rng.uniform(0, size, (len(radii), 2)).astype(np.float32), instance('spheres'),
                  channel(vector='x,y'))

        def loss(x):
            dx = x - math.rename_dims(x, 'spheres', 'o')
            dx = (dx + size / 2) % size - size / 2
            dr = math.vec_length(dx, eps=1e-8) / (R + math.rename_dims(R, 'spheres', 'o'))
            return math.l2_loss(math.where((dr < 2e-4) | (dr > 1), wrap(0.), 1 - dr))

        initial = float(loss(x0))
        t0 = time.perf_counter()
        with math.SolveTape() as tape:
            x_packed = math.minimize(loss, Solve('L-BFGS-B', abs_tol=1e-6, x0=x0, max_iterations=iterations)) % size
        seconds = time.perf_counter() - t0
        final = float(loss(x_packed))
    ok = final < initial * 0.05
    print(f'close-packing on {device}: overlap loss {initial:.4f} -> {final:.6f} in {tape[0].iterations} L-BFGS '
          f'iterations, {seconds * 1e3 / max(tape[0].iterations, 1):.2f} ms an iteration (the example asserts < '
          f'0.05 x): {"ok" if ok else "FAIL"}')
    if not ok:
        raise RuntimeError(f'close-packing: {initial} -> {final}')


def grid_names_cpu_vs_card(N=PATH_N):
    """The new grid names at full width, CPU against card on the same numpy
    inputs: `grid_sample` on 256³ (boundary halo) at 2^20 points by the
    per-corner route and at 2^16 points by the slab route, forced (the JAX
    package's rule never takes it at 256³; on the card also the slab route
    at 2^20 against the per-corner one), an `fft` → `ifft` round trip, `convolve` with a 3³
    kernel, `histogram` of 2^24 values. Each within GRID_NAMES_TOL of its
    scale (FFT_TOL for the transforms); card ms by CUDA events."""
    import numpy as np
    import torch
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.math import _nd, channel, instance, spatial
    from phiflow_tpu_torch.math._extrapolation import BOUNDARY
    rng = np.random.default_rng(17)
    grid_np = rng.standard_normal((N,) * 3).astype(np.float32)
    points_np = rng.uniform(-1.5, N + 0.5, (SAMPLE_POINTS, 3)).astype(np.float32)
    kernel_np = rng.standard_normal((3, 3, 3)).astype(np.float32)
    values_np = rng.standard_normal(HISTOGRAM_VALUES).astype(np.float32)

    def tensors(dev):
        grid = math.wrap(torch.from_numpy(grid_np).to(dev), spatial('x,y,z'))
        return grid, lambda n: math.wrap(torch.from_numpy(points_np[:n]).to(dev), instance('p'),
                                         channel(vector='x,y,z'))

    def route(sample, n):
        return lambda g, pts: sample(_nd._lookup_setup(g, pts(n), BOUNDARY))

    cases = {
        'grid_sample per-corner 2^20': route(_nd._corner_sample, SAMPLE_POINTS),
        'grid_sample slab 2^16': route(_nd._slab_sample, SLAB_POINTS),
        'fft': lambda g, pts: math.fft(g).native(),
        'fft -> ifft': lambda g, pts: math.real(math.ifft(math.fft(g))).native(),
        'convolve 3^3': lambda g, pts: math.convolve(g, math.wrap(torch.from_numpy(kernel_np).to(g.device),
                                                                  spatial('x,y,z'))).native(),
        'histogram counts': lambda g, pts: math.histogram(math.wrap(torch.from_numpy(values_np).to(g.device),
                                                                    instance('v')), bins=64)[0].native(),
        'histogram edges': lambda g, pts: math.histogram(math.wrap(torch.from_numpy(values_np).to(g.device),
                                                                   instance('v')), bins=64)[1].native(),
    }
    with math.default_device('cpu'):
        g, pts = tensors('cpu')
        ref = {name: fn(g, pts) for name, fn in cases.items()}
    with math.default_device('cuda'):
        g, pts = tensors('cuda')
        rule = _nd.slab_route(_nd._lookup_setup(g, pts(SLAB_POINTS), BOUNDARY))
        print(f'grid names {N}^3: the JAX package\'s rule takes the slab route at 2^16 points: {rule}')
        failed = []
        for name, fn in cases.items():
            got = fn(g, pts)
            ms = median_ms(lambda: fn(g, pts), reps=3, warmup=1)
            if got.is_complex():
                err = max(_scale_err(got.real, ref[name].real), _scale_err(got.imag, ref[name].imag))
            else:
                err = _scale_err(got, ref[name])
            tol = FFT_TOL if name.startswith('fft') else GRID_NAMES_TOL
            failed += [name] if not err <= tol else []
            print(f'grid names {N}^3 card vs CPU: {name}: max error {err:.2e} of scale (tol {tol:.0e}), card '
                  f'{ms:.3f} ms')
        slab_at = route(_nd._slab_sample, SAMPLE_POINTS)
        slab = slab_at(g, pts)
        err = _scale_err(slab, cases['grid_sample per-corner 2^20'](g, pts))
        failed += ['slab forced 2^20'] if not err <= GRID_NAMES_TOL else []
        print(f'grid names {N}^3 on the card: grid_sample slab route forced at 2^20 points against the per-corner '
              f'route: max error {err:.2e} of scale (tol {GRID_NAMES_TOL:.0e}), slab '
              f'{median_ms(lambda: slab_at(g, pts), reps=3, warmup=1):.3f} ms')
        del slab
    torch.cuda.empty_cache()
    if failed:
        raise RuntimeError(f'grid names CPU vs card: {failed}')


def run_optimisation():
    """Phase 7: PIV, the inverse smoke problem at 256³, close packing, and
    the new grid names CPU against card. Returns the inverse problem's
    launches for `launches_by_path`."""
    import torch
    card = card_line()
    print(f'phase 7 (optimisation) on {card}')
    t0 = time.perf_counter()
    part = PhaseClock('part of phase')
    run_piv()
    torch.cuda.empty_cache()
    part.done('7 PIV')
    by_path = {f'inverse-smoke-{PATH_N}': run_inverse_smoke()}
    torch.cuda.empty_cache()
    part.done('7 inverse smoke')
    run_close_packing()
    grid_names_cpu_vs_card()
    part.done('7 close packing and the grid names')
    print(f'phase 7 (optimisation): {time.perf_counter() - t0:.1f} s on {card}')
    return by_path


SOLVER_METHODS = ('CG', 'CG-adaptive', 'biCG-stab', 'biCG-stab(2)')
TUNNEL_RES = (512, 256, 256)  # Box(x=4, y=1, z=1): cells twice as long along x
TUNNEL_SOLVES = ('auto', 'CG-adaptive')
# max |div·active − its mean| after the tunnel's projections at 1e-4: ten times the larger first reading on an H100
# (9.022e-02 under 'auto', 8.804e-02 under 'CG-adaptive'; the cells are 1/128 × 1/256 × 1/256, so the divergence is
# in units 256 times those of the unit-cell paths)
TUNNEL_DIV_BOUND = 0.9


def pow2(x):
    """The power of two nearest x > 0: dividing by it is exact, bfloat16 ulps included."""
    import numpy as np
    return float(2.0 ** np.round(np.log2(x))) if x > 0 else 1.0


class Recorder:
    """Wraps functions of modules while a block runs; `keep(name, args, kwargs, kept)` returns entries {key: value}
    to keep from a call (the first value of each key stays), so that a kernel can be held against its twin on the
    inputs the path gave it."""

    def __init__(self, keep, **targets):
        self.keep, self.targets, self.kept = keep, targets, {}

    def __enter__(self):
        self.saved = {}
        for name, module in self.targets.items():
            fn = self.saved[name] = getattr(module, name)

            def wrapper(*args, _name=name, _fn=fn, **kwargs):
                for key, value in self.keep(_name, args, kwargs, self.kept).items():
                    self.kept.setdefault(key, value)
                return _fn(*args, **kwargs)
            setattr(module, name, wrapper)
        return self

    def __exit__(self, *exc):
        for name, module in self.targets.items():
            setattr(module, name, self.saved[name])


def check_tunnel_stencil(ch, kernel, case, p, inv_dx2, bcs, kw):
    """K1 / K1m against its twin on the tunnel's pressure `p` with the operator's own inv_dx2, sides and staged
    arrays: phase 3's 2e-5 (and 1e-5 of the dot) on p's system scaled to phase 3's (unit cells, p of unit standard
    deviation) by a power of two, s = std(p) · Σ inv_dx2 / 3."""
    from phiflow_tpu_torch.ops import poisson as P
    s = pow2(float(p.std()) * sum(inv_dx2) / 3)
    got, dot = P.poisson_apply(p, inv_dx2, bcs, with_dot=True, **kw)
    ref, rdot = P._poisson_apply_plain(p, inv_dx2, bcs, with_dot=True, **kw)
    ch.compare(kernel, f'{case} (÷ {s:g})', got / s, ref / s, 2e-5)
    ch.compare_dot(kernel, f'{case} (÷ {s:g})', dot, rdot, 1e-5)


def check_tunnel_vcycle(ch, case, kept, inv_dx2, bcs):
    """K2, K3 and K4 against their twins on the inputs the open tunnel's first V-cycle gave them at its finest
    level (`kept`): phase 3's tolerances (K2 2e-5, K3 1e-5, K4 exact) on the level scaled to phase 3's unit one by a
    power of two, s = std of the reference result (K2), max(std(b), std(u) · Σ inv_dx2 / 3) (K3)."""
    from phiflow_tpu_torch.ops import poisson as P
    from phiflow_tpu_torch.ops import transfer as T
    for key in ('zero-init', 'warm'):
        u, b, w, sweeps, out_dtype = kept[key]
        zero_init = key == 'zero-init'
        ref = P._poisson_smooth_plain(u, b, inv_dx2, bcs, w, sweeps, zero_init, out_dtype, False)
        s = pow2(float(ref.float().std()))
        got = P.poisson_smooth(u, b, inv_dx2, bcs, w, sweeps, zero_init=zero_init, out_dtype=out_dtype)
        ch.compare('jacobi_sweeps', f'{case} {key} sweeps={sweeps} {str(b.dtype)[6:]}->{str(out_dtype)[6:]} '
                   f'(÷ {s:g})', got / s, ref / s, 2e-5)
    u, b = kept['residual_restrict']
    s = pow2(max(float(b.float().std()), float(u.float().std()) * sum(inv_dx2) / 3))
    ch.compare('residual_restrict', f'{case} u {str(u.dtype)[6:]}, b {str(b.dtype)[6:]} (÷ {s:g})',
               P.residual_restrict(u, b, inv_dx2, bcs) / s, P._residual_restrict_plain(u, b, inv_dx2, bcs) / s, 1e-5)
    e, u = kept['prolong_add']
    ch.compare('prolong_add', f'{case} c {tuple(e.shape)} + u {tuple(u.shape)} {str(u.dtype)[6:]}',
               T.prolong_add(e, u), T._prolong_add_plain(e, u), 0.0)


def _keep_finest(shape):
    """`Recorder`'s keep for the solve's matvec and the V-cycle's kernels: the first matvec with its dot (its
    arguments), and the first call of each V-cycle kernel (K2 zero-init and warm) at the finest level `shape`, its
    tensors copied."""
    def keep(name, args, kwargs, kept):
        if name == 'poisson_apply':
            return {name: (args, kwargs)} if kwargs.get('with_dot') else {}
        if name == 'poisson_smooth':
            u, b, inv_dx2, bcs, w, sweeps = args
            key = 'zero-init' if kwargs.get('zero_init', False) else 'warm'
            if tuple(b.shape) != shape or key in kept:
                return {}
            return {key: (None if key == 'zero-init' else u.clone(), b.clone(), w, sweeps, kwargs.get('out_dtype'))}
        fine = args[0] if name == 'residual_restrict' else args[1]
        if tuple(fine.shape) != shape or name in kept:
            return {}
        return {name: (args[0].clone(), args[1].clone())}
    return keep


def levels_smoothed(shape):
    """The V-cycle's smoothed levels for a grid of `shape` under math/_multigrid.py's
    defaults (halving until an odd size or 4 cells, a direct solve up to 512 unknowns)."""
    import numpy as np
    levels, res = 1, tuple(shape)
    while not (any(n % 2 for n in res) or min(res) <= 4):
        res = tuple(n // 2 for n in res)
        levels += 1
    return levels - 1 if int(np.prod(res)) <= 512 else levels


def k1_per_solve(method, iterations, masked=False):
    """K1's (or K1m's) launches in one projection solve: A·x0, then CG one matvec an iteration, CG-adaptive A·d0
    besides, BiCGStab and BiCGStab(2) two (their `iterations` count matvecs / 2); under Chebyshev (masked) its two
    diagonal probes, three matvecs an application, one a solve and one an iteration."""
    if masked:
        return (7 if method == 'CG-adaptive' else 6) + 4 * iterations
    return {'CG': 1, 'auto': 1, 'CG-adaptive': 2}.get(method, 1) + (iterations if method in ('CG', 'auto', 'CG-adaptive')
                                                                     else 2 * iterations)


def check_launches(tag, launches, k1, v_cycles, shape, masked=False):
    """Raise unless the counted launches are K1 (masked: K1m in both its counters) exactly `k1`, K2 exactly its
    launches in `v_cycles` V-cycles on `shape`, K3 and K4 a whole positive number a V-cycle (0 without one)."""
    expected = {'poisson_stencil': k1, 'poisson_stencil_masked': k1 if masked else 0,
                'poisson_stencil_coeffs': k1 if masked else 0,
                'jacobi_sweeps': K2_LAUNCHES_PER_LEVEL * levels_smoothed(shape) * v_cycles}
    wrong = {k: (launches.get(k, 0), e) for k, e in expected.items() if launches.get(k, 0) != e}
    for k in ('residual_restrict', 'prolong_add'):
        count = launches.get(k, 0)
        if (count == 0 or count % v_cycles) if v_cycles else count:
            wrong[k] = (count, f'a positive multiple of {v_cycles} V-cycles' if v_cycles else 0)
    if k1 == 0 or wrong:
        raise RuntimeError(f'{tag}: launches (counted, expected): {wrong}')


def run_solver_methods(N=PATH_N, runs=3):
    """8a: the 256³ closed box with 4f's smooth divergent velocity and no obstacle, projected from x0 = 0 at
    1e-4 / 1e-4 (at most 500 iterations) by each of SOLVER_METHODS, 1 warm-up and `runs` timed solves: iterations,
    converged, ms, max |div|, ‖r‖ against ‖b‖. Gates: K1's exact launches a solve (K1m none); K2 exactly, K3 / K4
    a whole number a V-cycle for the CG family (preconditioned by the V-cycle, JAX's rule), none for the
    BiCGStab family (unpreconditioned); the CG family converged; every solve's residual below ‖b‖ and finite."""
    import torch
    from phiflow_tpu_torch.field import divergence_native
    from phiflow_tpu_torch.ops import _build
    from phiflow_tpu_torch.physics import fluid
    *vel, _, _ = smooth_state(N, 3)
    vel = tuple(torch.from_numpy(c).to('cuda') for c in vel)
    div0 = divergence_native(vel, 1.0)
    b_norm = float(torch.linalg.vector_norm((div0 - div0.mean()).double()))
    by_path = {}
    for method in SOLVER_METHODS:
        def solve():
            return fluid.make_incompressible_native(vel, None, 1.0, rel_tol=1e-4, abs_tol=1e-4, max_iterations=500,
                                                    method=method)
        solve()
        torch.cuda.synchronize()
        _build.reset_launches()
        times, results = [], []
        for _ in range(runs):
            t0 = time.perf_counter()
            v, p, result = solve()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            results.append(result)
        launches = dict(_build.LAUNCHES, solves=runs)
        iters = [r.iterations for r in results]
        cg_family = method in ('CG', 'CG-adaptive')
        residuals = [float(r.residual) for r in results]
        div = float(divergence_native(v, 1.0).abs().max())
        finite = all(bool(torch.isfinite(t).all()) for t in (*v, p))
        print(f'8a methods-{N} {method}: iterations {iters}, converged {[r.converged for r in results]}, '
              f'{statistics.median(times):.2f} ms a solve (median of {runs}: {", ".join(f"{t:.2f}" for t in times)}), '
              f'max |div| {div:.3e}, |r| {residuals[-1]:.3e} of |b| {b_norm:.3e}, all finite: {finite}; launches a '
              f'solve: ' + ', '.join(f'{k}={launches.get(k, 0) / runs:g}' for k in CG_KERNELS))
        check_launches(f'methods-{N} {method}', launches, sum(k1_per_solve(method, it) for it in iters),
                       sum(1 + it for it in iters) if cg_family else 0, (N,) * 3)
        if not (finite and all(r < b_norm for r in residuals) and (all(r.converged for r in results) or not cg_family)):
            raise RuntimeError(f'methods-{N} {method}: finite={finite} residuals={residuals} of {b_norm} '
                               f'converged={[r.converged for r in results]}')
        by_path[f'methods-{N}-{method}'] = launches
        del v, p
        torch.cuda.empty_cache()
    return by_path


def _tunnel_velocity(boundary):
    """A staggered velocity on TUNNEL_RES cells of Box(x=4, y=1, z=1) under `boundary`: 1 along x plus a
    smooth wave of 0.1 on every component, made on the card."""
    import numpy as np
    import torch
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.field import StaggeredGrid
    from phiflow_tpu_torch.geom import Box
    names = ('x', 'y', 'z')
    template = StaggeredGrid(0., boundary, bounds=Box(x=4, y=1, z=1), **dict(zip(names, TUNNEL_RES)))
    comps = []
    for a, d in enumerate(names):
        shape = tuple(template.vector[d].values.shape.only(names, reorder=True).sizes)
        g = torch.meshgrid(*[torch.arange(n, device='cuda', dtype=torch.float32) / n for n in shape], indexing='ij')
        wave = torch.sin(2 * np.pi * (g[0] + 2 * g[1] + 3 * g[2]) + a) * torch.cos(2 * np.pi * g[(a + 1) % 3])
        comps.append((1.0 if d == 'x' else 0.0) + 0.1 * wave)
    return template.with_values(math.stack([math.wrap(c, math.spatial(*names)) for c in comps],
                                           math.dual(vector=names)))


def run_tunnel(ch):
    """8c: the tunnel, TUNNEL_RES cells of Box(x=4, y=1, z=1) (twice as long along x), flow through the x walls
    at unit speed (boundary {'x': 1, 'y': 0, 'z': 0}) around a sphere of radius 0.25 at (1, 0.5, 0.5), projected
    through the Field API once per Solve of TUNNEL_SOLVES at 1e-4; gates: K1m's exact launches (Chebyshev),
    finite, max |div·active − its mean| under TUNNEL_DIV_BOUND, and K1m against its twin on the resulting
    pressure with the solve's own staged mA / c0 / active and unequal inv_dx2 (`check_tunnel_stencil`). Then the
    open box (ZERO_GRADIENT: both outer faces stored, the pressure 0 beyond them) without the sphere: K1 with
    ghost0 sides and the V-cycle (JAX's rule for 'auto'), exact launches, converged, finite, and K1, K2, K3 and
    K4 against their twins on the inputs the solve gave them (`check_tunnel_vcycle`). The inputs are recorded in
    the warm-up solve; the comparisons run after the counted one."""
    import torch
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.field import divergence, resample
    from phiflow_tpu_torch.geom import Sphere
    from phiflow_tpu_torch.math import Solve, SolveTape, extrapolation
    from phiflow_tpu_torch.math import _multigrid
    from phiflow_tpu_torch.ops import _build
    from phiflow_tpu_torch.physics import fluid
    failed = len(ch.failed)
    by_path = {}
    size = 'x'.join(str(n) for n in TUNNEL_RES)
    with math.default_device('cuda'):
        sphere = Sphere(x=1., y=0.5, z=0.5, radius=0.25)
        v0 = _tunnel_velocity({'x': 1, 'y': 0, 'z': 0})
        for method in TUNNEL_SOLVES:
            solve = Solve(method, 1e-4, 1e-4, max_iterations=500)
            with Recorder(_keep_finest(TUNNEL_RES), poisson_apply=fluid) as rec:
                fluid.make_incompressible(v0, [sphere], solve)  # warm-up
            torch.cuda.synchronize()
            _build.reset_launches()
            with SolveTape() as tape:
                t0 = time.perf_counter()
                v, p = fluid.make_incompressible(v0, [sphere], solve)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            launches = dict(_build.LAUNCHES)
            it = tape[0].iterations
            div = divergence(v)
            active = 1 - resample(sphere, div, soft=False).values.torch(('x', 'y', 'z'))
            d = div.values.torch(('x', 'y', 'z')) * active
            dev = float(((d - d.sum() / active.sum()) * active).abs().max())
            comps = [v.vector[n].values.torch(('x', 'y', 'z')) for n in 'xyz']
            finite = all(bool(torch.isfinite(t).all()) for t in (*comps, p.values.torch(('x', 'y', 'z'))))
            print(f'8c tunnel-{size} {method!r}: {ms:.2f} ms, {it} iterations, converged {tape[0].converged}, '
                  f'max |div·active − its mean| {dev:.3e} (bound {TUNNEL_DIV_BOUND}), blocked cells '
                  f'{int((active == 0).sum())}, all finite: {finite}, x faces {tuple(comps[0].shape)}; launches: '
                  + ', '.join(f'{k}={launches.get(k, 0)}' for k in CG_KERNELS))
            check_launches(f'tunnel {method}', launches, k1_per_solve(method, it, masked=True), 0, TUNNEL_RES, True)
            if not (finite and dev < TUNNEL_DIV_BOUND):
                raise RuntimeError(f'tunnel {method}: finite={finite} dev={dev}')
            by_path[f'tunnel-{size}-{method}'] = launches
            (_, inv_dx2, bcs), kw = rec.kept['poisson_apply']
            check_tunnel_stencil(ch, 'poisson_stencil_coeffs', f'tunnel {method!r} {size} mA+c0+active {bcs}',
                                 p.values.torch(('x', 'y', 'z')).contiguous(), inv_dx2, bcs,
                                 {k: kw[k] for k in ('mA_list', 'c0', 'active')})
            del v, p, div, d, active, comps, rec
            torch.cuda.empty_cache()
        v0 = _tunnel_velocity(extrapolation.ZERO_GRADIENT)
        solve = Solve('auto', 1e-4, 1e-4, max_iterations=500)
        with Recorder(_keep_finest(TUNNEL_RES), poisson_apply=fluid, poisson_smooth=_multigrid,
                      residual_restrict=_multigrid, prolong_add=_multigrid) as rec:
            fluid.make_incompressible(v0, (), solve)
        torch.cuda.synchronize()
        _build.reset_launches()
        with SolveTape() as tape:
            t0 = time.perf_counter()
            v, p = fluid.make_incompressible(v0, (), solve)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        launches = dict(_build.LAUNCHES)
        it = tape[0].iterations
        comps = [v.vector[n].values.torch(('x', 'y', 'z')) for n in 'xyz']
        div = float(divergence(v).values.torch(('x', 'y', 'z')).abs().max())
        finite = all(bool(torch.isfinite(t).all()) for t in (*comps, p.values.torch(('x', 'y', 'z'))))
        print(f'8c tunnel-{size}-open: {ms:.2f} ms, {it} iterations, converged {tape[0].converged}, max |div| '
              f'{div:.3e}, all finite: {finite}, x faces {tuple(comps[0].shape)}; launches: '
              + ', '.join(f'{k}={launches.get(k, 0)}' for k in CG_KERNELS))
        check_launches('tunnel open', launches, k1_per_solve('auto', it), 1 + it, TUNNEL_RES)
        if not (finite and tape[0].converged and tuple(comps[0].shape) == (TUNNEL_RES[0] + 1,) + TUNNEL_RES[1:]):
            raise RuntimeError(f'tunnel open: finite={finite} converged={tape[0].converged} {tuple(comps[0].shape)}')
        by_path[f'tunnel-{size}-open'] = launches
        (_, inv_dx2, bcs), kw = rec.kept['poisson_apply']
        check_tunnel_stencil(ch, 'poisson_stencil', f'tunnel open {size} {bcs}',
                             p.values.torch(('x', 'y', 'z')).contiguous(), inv_dx2, bcs, {})
        check_tunnel_vcycle(ch, f'tunnel open {size}', rec.kept, inv_dx2, bcs)
    if len(ch.failed) > failed:
        raise RuntimeError(f'tunnel: kernels against their twins failed: {ch.failed[failed:]}')
    return by_path


def fluid_logo(device, steps):
    """`examples/fluid_logo.py` at its 64² through the port's public functions: `steps` steps on `device`;
    returns (smoke, velocity, pressure, the logo geometry)."""
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.field import CenteredGrid, StaggeredGrid, resample
    from phiflow_tpu_torch.geom import Box, union
    from phiflow_tpu_torch.math import ConvergenceException, Solve, extrapolation
    from phiflow_tpu_torch.physics import advect, fluid
    with math.default_device(device):
        domain = dict(x=64, y=64, bounds=Box(x=100, y=100))
        geometry = union([Box(x=(15 + x * 7, 15 + (x + 1) * 7), y=(41, 83)) for x in range(1, 10, 2)] +
                         [Box(x=(43, 50), y=(41, 48)), Box(x=(15, 43), y=(83, 90)), Box(x=(50, 85), y=(83, 90))])
        zg = extrapolation.ZERO_GRADIENT
        inflow = CenteredGrid(Box(x=(14, 21), y=(6, 10)), zg, **domain) + \
            CenteredGrid(Box(x=(81, 88), y=(6, 10)), zg, **domain) * 0.9 + \
            CenteredGrid(Box(x=(44, 47), y=(49, 51)), zg, **domain) * 0.4
        v = StaggeredGrid(0, boundary=0, **domain)
        smoke = CenteredGrid(0, boundary=zg, **domain)
        p = CenteredGrid(0., fluid._pressure_extrapolation(v.boundary), **domain)
        for _ in range(steps):
            smoke = advect.semi_lagrangian(smoke, v, 1) + inflow
            v = advect.semi_lagrangian(v, v, 1) + resample(smoke * (0, 0.1), to=v)
            v, p = fluid.make_incompressible(v, geometry, Solve('CG-adaptive', 1e-5, 1e-5, x0=p,
                                                                suppress=(ConvergenceException,)))
        return smoke, v, p, geometry


def run_fluid_logo(steps=12):
    """8d: `examples/fluid_logo.py` on the card, its 12 steps, its three asserts as gates (finite, total smoke >
    10, max |div| outside the logo < 1e-2), launches (K7 by the 2D semi-Lagrangian lookups, if any); then 2 steps
    on the CPU and on the card from the example's initial state, within 1e-4 of each field's scale."""
    import torch
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.field import divergence, resample
    from phiflow_tpu_torch.ops import _build
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    smoke, v, p, geometry = fluid_logo('cuda', steps)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    launches = dict(_build.LAUNCHES, steps=steps)
    with math.default_device('cuda'):
        total = float(math.sum(smoke.values))
        vmax = float(math.max(abs(v.values)))
        div = divergence(v)
        div_out = float(math.max(abs(div.values) * (1 - resample(geometry, div, soft=False).values)))
    print(f'8d fluid-logo 64^2: {steps} steps, {ms:.2f} ms/step; total smoke {total:.2f}, max |v| {vmax:.3f}, max '
          f'|div| outside the logo {div_out:.2e}; launches: ' + ', '.join(f'{k}={c}' for k, c in launches.items()))
    import math as pymath
    if not (pymath.isfinite(total) and pymath.isfinite(vmax) and total > 10 and div_out < 1e-2):
        raise RuntimeError(f'fluid-logo: total={total} vmax={vmax} div_out={div_out}')
    card, cpu = fluid_logo('cuda', 2)[:3], fluid_logo('cpu', 2)[:3]
    errs = []
    for got, ref in zip(card, cpu):
        if got.is_staggered:
            errs += [_scale_err(got.vector[d].values.torch(('x', 'y')), ref.vector[d].values.torch(('x', 'y')))
                     for d in 'xy']
        else:
            errs.append(_scale_err(got.values.torch(('x', 'y')), ref.values.torch(('x', 'y'))))
    print(f'8d fluid-logo 64^2, 2 steps card vs CPU: scaled errors (smoke, v_x, v_y, p) '
          + ', '.join(f'{e:.2e}' for e in errs) + ' (tol 1e-4)')
    if max(errs) > 1e-4:
        raise RuntimeError(f'fluid-logo card vs CPU: {errs}')
    return {'fluid-logo-64': launches}


def _nested_domain(device):
    """`tests/physics/test_fluid.py::test_embedded_pressure_boundary_solve` on `device`: max |div| outside the
    sphere after the projection with and without it (the test's bound 1e-3), and the velocities."""
    import numpy as np
    import torch
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.field import CenteredGrid, StaggeredGrid, divergence, resample
    from phiflow_tpu_torch.geom import Box, Sphere
    from phiflow_tpu_torch.math import Solve, extrapolation
    from phiflow_tpu_torch.physics import fluid
    rng = np.random.default_rng(3)
    p_large, vx, vy = (rng.standard_normal(s).astype(np.float32) * 0.1 for s in ((32, 32), (49, 48), (48, 49)))
    with math.default_device(device):
        large, small = Box(x=100, y=100), Box(x=(30, 70), y=(40, 80))
        pl = CenteredGrid(math.wrap(torch.from_numpy(p_large).to(device), math.spatial('x,y')), extrapolation.BOUNDARY,
                          large, x=32, y=32)
        v = StaggeredGrid(0, extrapolation.ZERO_GRADIENT, bounds=small, x=48, y=48)
        v = v.with_values(math.stack([math.wrap(torch.from_numpy(a).to(device), math.spatial('x,y')) for a in (vx, vy)],
                                     math.dual(vector='x,y')))
        x0 = CenteredGrid(0, pl, bounds=small, resolution=v.resolution)
        out, divs = [], []
        for obstacles in ([Sphere(x=50, y=60, radius=5)], []):
            v2, p2 = fluid.make_incompressible(v, obstacles, Solve('CG', 1e-5, 1e-5, x0=x0, max_iterations=4000))
            div = divergence(v2)
            dd = math.abs(div.values)
            if obstacles:
                dd = dd * (1 - resample(obstacles[0], div, soft=False).values)
            divs.append(float(math.max(dd)))
            out += [v2.vector[d].values.torch(('x', 'y')) for d in 'xy']
        return divs, out


def run_small_solvers():
    """8e, card against CPU where both run: the direct solve of a Dirichlet Poisson system at 128² = 16384
    unknowns in float64 against CG at 1e-10 (1e-6 of scale) and its ms; the reroute warning at 20000
    unknowns; the Poiseuille march of `tests/physics/test_higher_order.py` with 'biCG-stab(2)' in float64
    (error under 2e-4 of the analytic scale, card vs CPU 1e-8); `matrix_from_function` of the 64² periodic
    Laplacian (5 entries a row, matrix @ v + bias == f(v)); the nested domain (max |div| under 1e-3 with and
    without the sphere, card vs CPU 1e-4 of scale). No kernel of ours is on these paths."""
    import warnings
    import numpy as np
    import torch
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.field import CenteredGrid
    from phiflow_tpu_torch.geom import Box
    from phiflow_tpu_torch.math import Solve, extrapolation, spatial
    from phiflow_tpu_torch.physics import diffuse

    def poisson(x):
        lo_x, up_x = math.shift(x, (-1, 1), 'x', extrapolation.ZERO, stack_dim=None)
        lo_y, up_y = math.shift(x, (-1, 1), 'y', extrapolation.ZERO, stack_dim=None)
        return 4 * x - lo_x - up_x - lo_y - up_y

    rng = np.random.default_rng(21)
    with math.precision(64), math.default_device('cuda'):
        rhs = math.tensor(torch.from_numpy(rng.standard_normal((128, 128))).to('cuda'), spatial('x,y'))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x_direct = math.solve_linear(poisson, rhs, Solve('direct', 1e-6, 1e-6))
        torch.cuda.synchronize()
        direct_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        x_direct = math.solve_linear(poisson, rhs, Solve('direct', 1e-6, 1e-6))
        torch.cuda.synchronize()
        direct_ms2 = (time.perf_counter() - t0) * 1e3
        x_cg = math.solve_linear(poisson, rhs, Solve('CG', 1e-10, 1e-10, max_iterations=20000))
        err = _scale_err(x_direct.torch(('x', 'y')), x_cg.torch(('x', 'y')))
        print(f'8e direct 128^2 (16384 unknowns, float64): {direct_ms:.2f} ms first, {direct_ms2:.2f} ms second '
              f'(the matrix built from the identity\'s columns as one batch, then torch.linalg.solve); against CG at '
              f'1e-10: {err:.2e} of scale (tol 1e-6); peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB')
        if err > 1e-6:
            raise RuntimeError(f'direct 128^2: {err}')
        del x_direct, x_cg
        torch.cuda.empty_cache()
        big = math.tensor(torch.from_numpy(rng.standard_normal(20000)).to('cuda'), spatial('x'))
        with warnings.catch_warnings(record=True) as record:
            warnings.simplefilter('always')
            x = math.solve_linear(lambda u: 3 * u - sum(math.shift(u, (-1, 1), 'x', extrapolation.ZERO, stack_dim=None)),
                                  big, Solve('scipy-direct', 1e-5, 1e-5))
        messages = [str(w.message) for w in record]
        print(f'8e direct at 20000 unknowns: warnings {messages}')
        if not any('BiCGStab' in m for m in messages) or not bool(math.all(math.is_finite(x))):
            raise RuntimeError(f'direct reroute: {messages}')

    def poiseuille(device):
        with math.precision(64), math.default_device(device):
            n, nu, G = 48, 0.1, 1.0
            u = CenteredGrid(0., extrapolation.ZERO, y=n, bounds=Box(y=1.))
            force = CenteredGrid(lambda pos: G * math.sin(np.pi * pos.vector['y']), extrapolation.ZERO, y=n,
                                 bounds=Box(y=1.))
            for _ in range(25):
                u = diffuse.implicit(u + 2.0 * force, nu, 2.0, order=6,
                                     solve=Solve('biCG-stab(2)', 1e-10, 1e-10, max_iterations=500))
            return u.values.torch('y')
    scale = 1.0 / (0.1 * np.pi ** 2)
    card, cpu = poiseuille('cuda'), poiseuille('cpu')
    analytic = torch.from_numpy(scale * np.sin(np.pi * (np.arange(48) + 0.5) / 48))
    err, apart = float((card.cpu() - analytic).abs().max()) / scale, _scale_err(card, cpu)
    print(f'8e Poiseuille (order 6, biCG-stab(2), float64): error {err:.3e} of the analytic scale (tol 2e-4); card '
          f'vs CPU {apart:.2e} (tol 1e-8)')
    if err > 2e-4 or apart > 1e-8:
        raise RuntimeError(f'Poiseuille: {err} {apart}')

    def matrix(device):
        with math.default_device(device):
            def f(x):  # the 5-point periodic Laplacian by shifts (JAX's and the port's `math.laplace` refuse 2D)
                lo_x, up_x = math.shift(x, (-1, 1), 'x', extrapolation.PERIODIC, stack_dim=None)
                lo_y, up_y = math.shift(x, (-1, 1), 'y', extrapolation.PERIODIC, stack_dim=None)
                return lo_x + up_x + lo_y + up_y - 4 * x
            m, bias = math.matrix_from_function(f, math.zeros(spatial(x=64, y=64)))
            v = math.tensor(torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32)).to(device),
                            spatial('x,y'))
            return m.entries, _scale_err((m @ v + bias).torch(('x', 'y')), f(v).torch(('x', 'y'))), m
    entries, err, m_card = matrix('cuda')
    entries_cpu, _, m_cpu = matrix('cpu')
    with math.default_device('cuda'):
        same = bool(torch.equal(math.dense(m_card).torch(('x', 'y', '~x', '~y')).cpu(),
                                math.dense(m_cpu).torch(('x', 'y', '~x', '~y')).cpu()))
    print(f'8e matrix_from_function 64^2 periodic Laplacian: {entries} entries (expected {5 * 64 * 64}; CPU '
          f'{entries_cpu}), matrix @ v + bias vs f(v) {err:.2e} of scale (tol 1e-5), the card\'s matrix equal to the '
          f'CPU\'s: {same}')
    if entries != 5 * 64 * 64 or entries_cpu != entries or err > 1e-5 or not same:
        raise RuntimeError('matrix_from_function')
    del m_card, m_cpu
    divs, card = _nested_domain('cuda')
    divs_cpu, cpu = _nested_domain('cpu')
    errs = [_scale_err(a, b) for a, b in zip(card, cpu)]
    print(f'8e nested domain 48^2: max |div| with / without the sphere {divs[0]:.2e} / {divs[1]:.2e} (tol 1e-3; '
          f'CPU {divs_cpu[0]:.2e} / {divs_cpu[1]:.2e}); card vs CPU velocities {max(errs):.2e} of scale (tol 1e-4)')
    if max(divs) > 1e-3 or max(errs) > 1e-4:
        raise RuntimeError(f'nested domain: {divs} {errs}')


def run_solvers(ch):
    """Phase 8, solvers and projections: 8a–8e. Returns the paths' launches for `launches_by_path`."""
    import torch
    card = card_line()
    print(f'phase 8 (solvers and projections) on {card}')
    t0 = time.perf_counter()
    part = PhaseClock('part of phase')
    by_path = run_solver_methods()
    torch.cuda.empty_cache()
    part.done('8a methods')
    by_path[f'obstacle-{OBSTACLE_N}-adaptive'] = run_obstacles(f'obstacle-{OBSTACLE_N}-adaptive', OBSTACLE_N, warmup=1,
                                                               steps=2, method='CG-adaptive')
    torch.cuda.empty_cache()
    part.done('8b obstacle adaptive')
    by_path.update(run_tunnel(ch))
    torch.cuda.empty_cache()
    part.done('8c tunnel')
    by_path.update(run_fluid_logo())
    run_small_solvers()
    part.done('8d-8e fluid logo and the small solvers')
    torch.cuda.empty_cache()
    print(f'phase 8 (solvers and projections): {time.perf_counter() - t0:.1f} s on {card}')
    return by_path


def print_path_gaps(ch, by_path):
    """K1m's, K6's and K8's launches a step on each path that runs them ×
    (device − bound) of the row timed at that path's shape: K1m's coefficient
    row (obstacle masks, 256³) on the obstacle paths, its active row (128³) on
    FLIP 128³; K6's rows with and without the extrema, by the step's mix; K8's
    whole mean at each FLIP size, three onto face grids (the x faces' row) and
    one onto the cells."""
    k1m = {'poisson_stencil_coeffs': [f'obstacle-{OBSTACLE_N}', f'obstacle-{OBSTACLE_N}-vcycle'],
           'poisson_stencil_masked': [f'flip-{FLIP_N[0]}']}
    gaps = {}
    for kernel, tags in k1m.items():
        row = ch.timing[kernel]
        for tag in tags:
            per_step = by_path[tag][kernel] / by_path[tag]['steps']
            gaps.setdefault(tag, []).append(f'K1m {per_step:g} x ({row["device_ms"]:.4f} - {row["bound_ms"]:.4f}) = '
                                            f'{per_step * (row["device_ms"] - row["bound_ms"]):.4f} ms')
    k6 = ch.timing['window_interp_3d']
    k6x = k6['parts']['window_interp_3d +extrema']
    for tag, with_extrema in K6_EXTREMA_PER_STEP.items():
        per_step = by_path[tag]['window_interp_3d'] / by_path[tag]['steps']
        gap = (with_extrema * (k6x['device_ms'] - k6x['bound_ms'])
               + (per_step - with_extrema) * (k6['device_ms'] - k6['bound_ms']))
        gaps.setdefault(tag, []).append(f'K6 {with_extrema:g} with extrema + {per_step - with_extrema:g} without '
                                        f'= {gap:.4f} ms')
    for N in FLIP_N:
        tag = f'flip-{N}'
        per_step = by_path[tag]['p2g_mean'] / by_path[tag]['steps']
        faces, cells = (p2g_timing(ch, 'p2g_mean', N, 'path order', g) for g in ('x faces', 'cells'))
        gap = (per_step - 1) * (faces['device_ms'] - faces['bound_ms']) + (cells['device_ms'] - cells['bound_ms'])
        gaps.setdefault(tag, []).append(f'K8 mean {per_step - 1:g} x ({faces["device_ms"]:.4f} - '
                                        f'{faces["bound_ms"]:.4f}) + 1 x ({cells["device_ms"]:.4f} - '
                                        f'{cells["bound_ms"]:.4f}) = {gap:.4f} ms')
    for tag, parts in gaps.items():
        print(f'gaps  {tag}: launches a step x (device - bound): ' + '; '.join(parts))


def ptxas_entries(log):
    """(kernel, registers, spill-store bytes, spill-load bytes, stack-frame
    bytes) of each entry function in a `ptxas -v` log, the names demangled
    by `c++filt` where it is installed."""
    import shutil
    entries, name, spill, load, stack = [], None, 0, 0, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill, load, stack = m.group(1), 0, 0, 0
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads', line)
        if m:
            stack, spill, load = (int(x) for x in m.groups())
        m = re.search(r'Used (\d+) registers', line)
        if m and name is not None:
            entries.append([name, int(m.group(1)), spill, load, stack])
            name = None
    if shutil.which('c++filt') and entries:
        out = subprocess.run(['c++filt'], input='\n'.join(e[0] for e in entries), capture_output=True, text=True,
                             timeout=60, check=True).stdout.splitlines()
        for e, demangled in zip(entries, out):
            e[0] = demangled.split('(')[0]
    return entries


# ---------------------------------------------------------------------------
# phase 9: batched simulation
# ---------------------------------------------------------------------------

BATCH_B = 4
BATCH_N = 128  # 9a: the 3D kernels at B = 4 × 128³
BATCH_ODD = (3, RAGGED)  # and at B = 3 × a shape of no power of two (the march kernels' scalar route)
BATCH_N_2D = 1024  # 9a: K7 and K7ᵀ at B = 4 × 1024²
BATCH_SMOKE_N = 256  # 9b: batched-smoke-256x4
BATCH_WIDE_N, BATCH_WIDE_B = 128, 16  # and batched-smoke-128x16: the per-entry reductions' cost at a larger batch
BATCH_RECIPE_N, BATCH_RECIPE_STEPS = 64, 30  # 9c: examples/batched_smoke.py's own size and steps
BATCH_RATES = (0.2, 0.5, 1.0, 2.0)  # its four inflow rates
# the batched forms in the `kernels` line: row name → the launch counter its launches go under (one per call)
BATCHED_ROWS = {f'{k}_batched': k for k in BATCHED_KERNELS}
ENTRY_DOT_RTOL = 1e-6  # a batched launch's dot of an entry against that entry's own launch: the blocks' partials
# are the same, summed in another order


def _launch_once(ch, row, case, fn):
    """`fn()` with the launches of `row`'s counter counted: exactly one. Returns fn's result."""
    from phiflow_tpu_torch.ops import _build
    counter = BATCHED_ROWS[row]
    before = _build.LAUNCHES[counter]
    out = fn()
    n = _build.LAUNCHES[counter] - before
    ok = n == 1
    print(f'check {row:17s} {case:58s} launches {n} (one for the batch) {"ok" if ok else "FAIL"}')
    if not ok:
        ch.failed.append(f'{row} {case} launches {n}')
    ch.passed[row] += ok
    return out


def _entries_equal(ch, row, case, got, per_entry):
    """Each entry of a batched launch's output bit-equal to its own launch."""
    for e, ref in enumerate(per_entry):
        ch.compare(row, f'{case} entry {e} = its own launch', got[e], ref, 0.0)


def check_batched_kernels(ch, gen, quick):
    """9a: K1 (matvec and its epilogues, with the dot), K2 (the zero-init pre-smooth and the post-smooth with its
    dot), K3 and K4 at B = 4 × 128³ and B = 3 × RAGGED, K1m there with masks shared by the batch and with masks
    per entry (coefficient arrays and active cells); K6 at B = 4 × 128³ with a batched and a shared
    displacement, K7 at B = 4 × 1024²; K6ᵀ / K7ᵀ at the same shapes, and with a shared grid. Each against its
    twin at phase 3's tolerances, entry by entry against the unbatched launch on that entry (outputs bit-equal,
    dots within 1e-6 relative; K6ᵀ / K7ᵀ: d_grid and d_disp bit-equal; a shared grid's d_grid bit-equal to the
    entries' own d_grid summed in entry order), and to exactly one launch a batched call. Then (not with --quick) each batched form timed at
    B = 4 beside its unbatched launch on one entry (`entry` part of its row: 4 × that is the unbatched cost)."""
    import torch
    from phiflow_tpu_torch.ops import interp as I
    from phiflow_tpu_torch.ops import poisson as P
    from phiflow_tpu_torch.ops import transfer as T
    dev = 'cuda'
    f32, bf16 = torch.float32, torch.bfloat16

    def rnd(shape, dtype=f32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    cases = [(BATCH_B, (BATCH_N,) * 3, PATH_BC, (1.0, 1.0, 1.0)), (*BATCH_ODD, BC_SETS[2], (1.0, 0.7, 1.3))]
    for B, shape, bcs, inv in cases:
        tag = f'B={B} x {shape}'
        w = 0.9 / (-2.0 * sum(inv))
        p, b = rnd((B,) + shape), rnd((B,) + shape)
        row = 'poisson_stencil_batched'
        for mode in ('matvec', 'residual', 'jacobi'):
            case = f'{mode} +dot {tag}'
            kw = dict(b=b, mode=mode, omega_over_diag=0.15, with_dot=True)
            got, dot = _launch_once(ch, row, case, lambda: P.poisson_apply(p, inv, bcs, **kw))
            ref, rdot = P._poisson_apply_plain(p, inv, bcs, **kw)
            ch.compare(row, case + ' vs twin', got, ref, 2e-5)
            for e in range(B):
                ch.compare_dot(row, f'{case} entry {e} vs twin', dot[e], rdot[e], 1e-5)
                g1, d1 = P.poisson_apply(p[e], inv, bcs, b=b[e], mode=mode, omega_over_diag=0.15, with_dot=True)
                ch.compare(row, f'{case} entry {e} = its own launch', got[e], g1, 0.0)
                ch.compare_dot(row, f'{case} entry {e} dot vs its own launch', dot[e], d1, ENTRY_DOT_RTOL)
        row = 'jacobi_sweeps_batched'
        pre = _launch_once(ch, row, f'pre-smooth zero-init x3 f32->bf16 {tag}',
                           lambda: P.poisson_smooth(None, b, inv, bcs, w, 3, zero_init=True, out_dtype=bf16))
        ch.compare(row, f'pre-smooth {tag} vs twin', pre, P._poisson_smooth_plain(None, b, inv, bcs, w, 3, True,
                                                                                bf16, False), 2e-5)
        _entries_equal(ch, row, f'pre-smooth {tag}', pre, [P.poisson_smooth(None, b[e], inv, bcs, w, 3, zero_init=True,
                                                                           out_dtype=bf16) for e in range(B)])
        post, dot = _launch_once(ch, row, f'post-smooth x3 bf16->f32 +dot {tag}',
                                 lambda: P.poisson_smooth(pre, b, inv, bcs, w, 3, out_dtype=f32, emit_dot=True))
        ref, rdot = P._poisson_smooth_plain(pre, b, inv, bcs, w, 3, False, f32, True)
        ch.compare(row, f'post-smooth {tag} vs twin', post, ref, 2e-5)
        for e in range(B):
            ch.compare_dot(row, f'post-smooth {tag} entry {e} vs twin', dot[e], rdot[e], 1e-5)
            g1, d1 = P.poisson_smooth(pre[e], b[e], inv, bcs, w, 3, out_dtype=f32, emit_dot=True)
            ch.compare(row, f'post-smooth {tag} entry {e} = its own launch', post[e], g1, 0.0)
            ch.compare_dot(row, f'post-smooth {tag} entry {e} dot vs its own launch', dot[e], d1, ENTRY_DOT_RTOL)
        row = 'residual_restrict_batched'
        got = _launch_once(ch, row, f'u bf16, b f32 {tag}', lambda: P.residual_restrict(pre, b, inv, bcs))
        ch.compare(row, f'u bf16, b f32 {tag} vs twin', got, P._residual_restrict_plain(pre, b, inv, bcs), 1e-5)
        _entries_equal(ch, row, f'u bf16, b f32 {tag}', got,
                       [P.residual_restrict(pre[e], b[e], inv, bcs) for e in range(B)])
        row = 'prolong_add_batched'
        c = rnd((B,) + tuple(n // 2 for n in shape), bf16)
        got = _launch_once(ch, row, f'bf16 {tag}', lambda: T.prolong_add(c, pre))
        ch.compare(row, f'bf16 {tag} vs twin', got, T._prolong_add_plain(c, pre), 0.0)
        _entries_equal(ch, row, f'bf16 {tag}', got, [T.prolong_add(c[e], pre[e]) for e in range(B)])
        # K1m over the batch: one set of masks shared by the entries (read in place at an entry stride of 0) and a
        # set an entry (the JAX package's `poisson_apply` takes either), the coefficient arrays and the active cells
        row = 'poisson_stencil_masked_batched'
        sets = []
        for _ in range(B):
            mA, c0 = P.stage_masks(_random_face_masks(shape, bcs, gen, dev), bcs, inv)
            sets.append(mA + [c0, (torch.rand(shape, generator=gen, device=dev) < 0.7).float()])
        for kind, masks in (('shared masks', sets[0]), ('masks per entry', [torch.stack(m) for m in zip(*sets)])):
            kw = dict(mA_list=masks[:3], c0=masks[3], active=masks[4])
            for mode in ('matvec', 'residual', 'jacobi'):
                case = f'mA+c0+active {mode} +dot {tag}, {kind}'
                args = dict(b=b, mode=mode, omega_over_diag=0.15, with_dot=True, **kw)
                got, dot = _launch_once(ch, row, case, lambda: P.poisson_apply(p, inv, bcs, **args))
                ref, rdot = P._poisson_apply_plain(p, inv, bcs, **args)
                ch.compare(row, case + ' vs twin', got, ref, 2e-5)
                for e in range(B):
                    ch.compare_dot(row, f'{case} entry {e} vs twin', dot[e], rdot[e], 1e-5)
                    own = [m if kind == 'shared masks' else m[e] for m in masks]
                    g1, d1 = P.poisson_apply(p[e], inv, bcs, mA_list=own[:3], c0=own[3], active=own[4], b=b[e],
                                             mode=mode, omega_over_diag=0.15, with_dot=True)
                    ch.compare(row, f'{case} entry {e} = its own launch', got[e], g1, 0.0)
                    ch.compare_dot(row, f'{case} entry {e} dot vs its own launch', dot[e], d1, ENTRY_DOT_RTOL)
        del p, b, pre, post, c, got, sets
    fns = {3: I.window_interp_3d, 2: I.window_interp_2d}
    for d, shape in ((3, (BATCH_N,) * 3), (2, (BATCH_N_2D,) * 2)):
        row, grow = f'window_interp_{d}d_batched', f'window_interp_{d}d_grad_batched'
        scale = (-0.5,) * d
        grid = torch.rand((BATCH_B,) + shape, generator=gen, device=dev)
        batched = [torch.rand((BATCH_B,) + shape, generator=gen, device=dev) * 5.0 - 2.5 for _ in range(d)]
        shared = [x[1].contiguous() for x in batched]
        for disp_kind, disps in (('batched', batched), ('shared', shared)):
            for mode, extrema in (('edge', True), ('const', False)):
                case = f'B={BATCH_B} x {shape} K=1 {mode}{" extrema" if extrema else ""}, {disp_kind} displacement'
                halo = dict(halo='edge') if mode == 'edge' else dict(const_pad=0.0)
                got = _launch_once(ch, row, case, lambda: fns[d](grid, disps, 1, compute_extrema=extrema,
                                                               disp_scale=scale, **halo))
                ref = I._window_interp_plain(grid, disps, 1, extrema, tuple(I._f32(x) for x in scale), mode, 0.0)
                got, ref = (got, ref) if extrema else ((got,), (ref,))
                ch.compare(row, case + ' value vs twin', got[0], ref[0], 1e-5)
                for what, g, r in zip(('lo', 'up'), got[1:], ref[1:]):
                    ch.compare(row, f'{case} {what} vs twin (exact)', g, r, 0.0)
                for e in range(BATCH_B):
                    one = fns[d](grid[e], [x if disp_kind == 'shared' else x[e] for x in disps], 1,
                                 compute_extrema=extrema, disp_scale=scale, **halo)
                    one = one if extrema else (one,)
                    for k, (g, r) in enumerate(zip(got, one)):
                        ch.compare(row, f'{case} out {k} entry {e} = its own launch', g[e], r, 0.0)
                ups = [torch.randn((BATCH_B,) + shape, generator=gen, device=dev) for _ in range(3 if extrema else 1)]
                gg = _launch_once(ch, grow, case, lambda: _grad_call(d, grid, disps, 1, extrema, scale, mode, 0.0, ups,
                                                                    False))
                _grad_compare_row(ch, grow, case + ' vs twin VJP', gg,
                                  _grad_call(d, grid, disps, 1, extrema, scale, mode, 0.0, ups, True))
                for e in range(BATCH_B):
                    ge = _grad_call(d, grid[e], [x if disp_kind == 'shared' else x[e] for x in disps], 1, extrema,
                                    scale, mode, 0.0, [u[e] for u in ups], False)
                    ch.compare(grow, f'{case} d_grid entry {e} = its own launch', gg[0][e], ge[0], 0.0)
                    if disp_kind == 'batched':
                        for i in range(d):
                            ch.compare(grow, f'{case} d_disp[{i}] entry {e} = its own launch', gg[1][i][e], ge[1][i],
                                       0.0)
        # a shared grid: one d_grid, its cells adding the entries in order
        case = f'B={BATCH_B} x {shape} K=1 edge extrema, shared grid'
        ups = [torch.randn((BATCH_B,) + shape, generator=gen, device=dev) for _ in range(3)]
        gg = _launch_once(ch, grow, case, lambda: _grad_call(d, grid[0], batched, 1, True, scale, 'edge', 0.0, ups,
                                                             False))
        _grad_compare_row(ch, grow, case + ' vs twin VJP', gg,
                          _grad_call(d, grid[0], batched, 1, True, scale, 'edge', 0.0, ups, True))
        total = None
        for e in range(BATCH_B):
            ge = _grad_call(d, grid[0], [x[e] for x in batched], 1, True, scale, 'edge', 0.0, [u[e] for u in ups],
                            False)
            total = ge[0] if total is None else total + ge[0]
            for i in range(d):
                ch.compare(grow, f'{case} d_disp[{i}] entry {e} = its own launch', gg[1][i][e], ge[1][i], 0.0)
        ch.compare(grow, f'{case} d_grid = the entries\' own, summed in order', gg[0], total, 0.0)
        del grid, batched, shared, got, ref, gg, total
        torch.cuda.empty_cache()
    if quick:
        return
    time_batched_kernels(ch, gen)


def _grad_compare_row(ch, row, case, got, ref):
    (g_grid, g_disp), (r_grid, r_disp) = got, ref
    for what, g, r in [('d_grid', g_grid, r_grid)] + [(f'd_disp[{i}]', a, b) for i, (a, b) in
                                                      enumerate(zip(g_disp, r_disp))]:
        ch.compare(row, f'{case} {what}', g, r, GRAD_TOL * max(float(r.abs().max()), 1e-30))


def time_batched_kernels(ch, gen):
    """Each batched form at B = 4 (4 × 128³; K7 4 × 1024²) as the batched step calls it, beside its unbatched
    launch on one entry (the row's `entry` part: device_ms of one entry; 4 × that is the unbatched cost)."""
    import torch
    from phiflow_tpu_torch.ops import poisson as P
    from phiflow_tpu_torch.ops import transfer as T
    dev = 'cuda'
    B, N3, one = BATCH_B, (BATCH_N,) * 3, (1.0, 1.0, 1.0)
    f32, bf16 = torch.float32, torch.bfloat16
    w = 0.9 / -6.0
    p = torch.randn((B,) + N3, generator=gen, device=dev)
    b = torch.randn((B,) + N3, generator=gen, device=dev)
    weight = torch.zeros((1, 1, 3, 3, 3), device=dev)
    weight[0, 0, 1, 1, 1] = -6.0
    for c in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0), (1, 1, 2)):
        weight[(0, 0) + c] = 1.0
    F = torch.nn.functional

    def timed(row, what, batched, plain, entry, entry_plain, n_bytes, n_ops, library=None, entry_library=None):
        ch.time(row, f'{what}, B={B}', batched, plain, n_bytes, n_ops, library)
        ch.time(row, f'{what}, one entry (unbatched launch)', entry, entry_plain, n_bytes / B, n_ops / B,
                entry_library, key=row + ' entry')
        ch.attach(row, [row + ' entry'])
        print(f'note  {row:17s} B={B}: device {ch.timing[row]["device_ms"]:.4f} ms vs {B} x unbatched '
              f'{B * ch.timing[row]["parts"][row + " entry"]["device_ms"]:.4f} ms')

    # K1m over the batch with the obstacle path's masks (shared): the bound counts them once; each entry re-reading
    # them would add (B − 1) × 5 masks' bytes, printed beside it
    mA, c0, accessible = obstacle_masks(BATCH_N)
    kw = dict(mA_list=mA, c0=c0, active=accessible, with_dot=True)
    out = P.poisson_apply(p, one, PATH_BC, **kw)[0]
    masks_bytes = nbytes(*mA, c0, accessible)
    timed('poisson_stencil_masked_batched', f'matvec + dot {N3} f32, shared obstacle masks mA + c0 + active',
          lambda: P.poisson_apply(p, one, PATH_BC, **kw), lambda: P._poisson_apply_plain(p, one, PATH_BC, **kw),
          lambda: P.poisson_apply(p[0], one, PATH_BC, **kw), lambda: P._poisson_apply_plain(p[0], one, PATH_BC, **kw),
          nbytes(p, out) + masks_bytes, 22 * p.numel())
    print(f'note  poisson_stencil_masked_batched bound with the masks read by every entry: '
          f'{(nbytes(p, out) + B * masks_bytes) / HBM_BYTES_PER_S * 1e3:.4f} ms; masks once '
          f'{ch.timing["poisson_stencil_masked_batched"]["bound_ms"]:.4f} ms')
    del mA, c0, accessible, kw, out
    timed('poisson_stencil_batched', f'matvec + dot {N3} f32', lambda: P.poisson_apply(p, one, PATH_BC, with_dot=True),
          lambda: P._poisson_apply_plain(p, one, PATH_BC, with_dot=True),
          lambda: P.poisson_apply(p[0], one, PATH_BC, with_dot=True),
          lambda: P._poisson_apply_plain(p[0], one, PATH_BC, with_dot=True), nbytes(p, p), 22 * p.numel(),
          lambda: F.conv3d(F.pad(p[:, None], (1,) * 6, mode='replicate'), weight),
          lambda: F.conv3d(F.pad(p[0][None, None], (1,) * 6, mode='replicate'), weight))
    pre = P.poisson_smooth(None, b, one, PATH_BC, w, 3, zero_init=True, out_dtype=bf16)
    timed('jacobi_sweeps_batched', f'post-smooth x3 bf16->f32 +dot {N3}',
          lambda: P.poisson_smooth(pre, b, one, PATH_BC, w, 3, out_dtype=f32, emit_dot=True),
          lambda: P._poisson_smooth_plain(pre, b, one, PATH_BC, w, 3, False, f32, True),
          lambda: P.poisson_smooth(pre[0], b[0], one, PATH_BC, w, 3, out_dtype=f32, emit_dot=True),
          lambda: P._poisson_smooth_plain(pre[0], b[0], one, PATH_BC, w, 3, False, f32, True),
          nbytes(pre, b, b), 3 * 24 * b.numel())
    out = P.residual_restrict(pre, b, one, PATH_BC)
    timed('residual_restrict_batched', f'u bf16, b f32 {N3} -> bf16', lambda: P.residual_restrict(pre, b, one, PATH_BC),
          lambda: P._residual_restrict_plain(pre, b, one, PATH_BC),
          lambda: P.residual_restrict(pre[0], b[0], one, PATH_BC),
          lambda: P._residual_restrict_plain(pre[0], b[0], one, PATH_BC), nbytes(pre, b, out), 23 * pre.numel())
    c = out
    got = T.prolong_add(c, pre)
    timed('prolong_add_batched', f'c {tuple(c.shape[1:])} + u {N3} bf16', lambda: T.prolong_add(c, pre),
          lambda: T._prolong_add_plain(c, pre), lambda: T.prolong_add(c[0], pre[0]),
          lambda: T._prolong_add_plain(c[0], pre[0]), nbytes(c, pre, got),
          pre.numel(), lambda: F.interpolate(c[:, None], scale_factor=2, mode='nearest'),
          lambda: F.interpolate(c[0][None, None], scale_factor=2, mode='nearest'))
    del p, b, pre, out, c, got
    torch.cuda.empty_cache()
    from phiflow_tpu_torch.ops import interp as I
    fns = {3: I.window_interp_3d, 2: I.window_interp_2d}
    for d, shape in ((3, N3), (2, (BATCH_N_2D,) * 2)):
        scale = (-0.5,) * d
        grid = torch.rand((B,) + shape, generator=gen, device=dev)
        disps = [torch.rand((B,) + shape, generator=gen, device=dev) * 5.0 - 2.5 for _ in range(d)]
        n = grid.numel()
        ops = (2 ** d * (d + 1) + 8 * d) * n + 2 ** (d + 1) * n
        fn = fns[d]
        row = f'window_interp_{d}d_batched'
        timed(row, f'smoke forward: edge halo + extrema {shape} K=1',
              lambda: fn(grid, disps, 1, compute_extrema=True, disp_scale=scale, halo='edge'),
              lambda: I._window_interp_plain(grid, disps, 1, True, scale, 'edge', 0.0),
              lambda: fn(grid[0], [x[0] for x in disps], 1, compute_extrema=True, disp_scale=scale, halo='edge'),
              lambda: I._window_interp_plain(grid[0], [x[0] for x in disps], 1, True, scale, 'edge', 0.0),
              nbytes(grid, *disps) + 3 * nbytes(grid), ops, _grid_sample_lookup(grid, disps, 1, scale, 'border'),
              _grid_sample_lookup(grid[0], [x[0] for x in disps], 1, scale, 'border'))
        ups = [torch.randn((B,) + shape, generator=gen, device=dev)]
        gops = (2 ** d * (d * d + d + 1) + 32 * d) * n
        timed(f'window_interp_{d}d_grad_batched', f'velocity component: const halo {shape} K=1',
              lambda: _grad_call(d, grid, disps, 1, False, scale, 'const', 0.0, ups, False),
              lambda: _grad_call(d, grid, disps, 1, False, scale, 'const', 0.0, ups, True),
              lambda: _grad_call(d, grid[0], [x[0] for x in disps], 1, False, scale, 'const', 0.0, [ups[0][0]], False),
              lambda: _grad_call(d, grid[0], [x[0] for x in disps], 1, False, scale, 'const', 0.0, [ups[0][0]], True),
              nbytes(grid, *disps, *ups) + nbytes(grid, *disps), gops,
              _grid_sample_backward(grid, disps, 1, scale, 'zeros', ups[0]),
              _grid_sample_backward(grid[0], [x[0] for x in disps], 1, scale, 'zeros', ups[0][0]))
        del grid, disps, ups
        torch.cuda.empty_cache()


def _stack_states(states):
    """Numpy states (velocity components, smoke, pressure) stacked along a leading batch axis, as CUDA arrays."""
    import numpy as np
    from phiflow_tpu_torch.models import state_from_numpy
    return state_from_numpy(*[np.stack(parts) for parts in zip(*states)], device='cuda')


def _unbatched_launches(model, state, steps):
    """`steps` Field steps of `model` from one entry's array state: (final natives, CG counts, launches)."""
    import torch
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.ops import _build
    step, _ = _stepper(model, True)
    v, s, p = model.state_fields(*state)
    torch.cuda.synchronize()
    _build.reset_launches()
    with math.SolveTape() as tape:
        for _ in range(steps):
            v, s, p = step(v, s, p)
    torch.cuda.synchronize()
    return model.state_natives(v, s, p), [i.iterations for i in tape], dict(_build.LAUNCHES)


def _keep_batched_calls(name, args, kwargs, kept):
    """`Recorder`'s keep for a batched step: the first matvec with its dot on a nonzero direction (K1's
    arguments) and the first K6 lookup of each grid shape, with or without extrema (its arguments)."""
    if name == 'poisson_apply':
        return {name: (args, kwargs)} if kwargs.get('with_dot') and name not in kept and bool(args[0].any()) else {}
    return {(name, tuple(args[0].shape), bool(kwargs.get('compute_extrema'))): (args, kwargs)}


def check_batched_path_kernels(ch, tag, kept):
    """Batched K1 and K6 against their twins on the inputs a batched step gave them (`_keep_batched_calls`):
    phase 3's tolerances — K1 2e-5 on the system scaled by a power of two as `check_tunnel_stencil` scales it,
    each entry's dot 1e-5; K6 values 1e-5, lo / up exactly."""
    from phiflow_tpu_torch.ops import interp as I
    from phiflow_tpu_torch.ops import poisson as P
    (p, inv_dx2, bcs), kw = kept.pop('poisson_apply')
    s = pow2(float(p.std()) * sum(inv_dx2) / 3)
    row, case = 'poisson_stencil_batched', f'{tag} CG matvec +dot {tuple(p.shape)}'
    got, dot = P.poisson_apply(p, inv_dx2, bcs, **kw)
    ref, rdot = P._poisson_apply_plain(p, inv_dx2, bcs, **kw)
    ch.compare(row, f'{case} vs twin (÷ {s:g})', got / s, ref / s, 2e-5)
    for e in range(p.shape[0]):
        ch.compare_dot(row, f'{case} entry {e} dot vs twin', dot[e], rdot[e], 1e-5)
    del got, ref
    row = 'window_interp_3d_batched'
    for (_, shape, extrema), ((grid, disps, K), kw) in kept.items():
        mode = 'const' if kw.get('const_pad') is not None else kw.get('halo')
        sgn = -1.0 if kw.get('negate') else 1.0
        scale = tuple(I._f32(sgn * x) for x in (kw.get('disp_scale') or (1.0,) * 3))
        case = (f'{tag} lookup {shape} {mode or "padded"}{" extrema" if extrema else ""}, displacement '
                f'{tuple(disps[0].shape)}')
        got = I.window_interp_3d(grid, disps, K, **kw)
        ref = I._window_interp_plain(grid, list(disps), K, extrema, scale, mode, I._f32(kw.get('const_pad') or 0.0))
        got, ref = (got, ref) if extrema else ((got,), (ref,))
        ch.compare(row, case + ' value vs twin', got[0], ref[0], 1e-5)
        for what, g, r in zip(('lo', 'up'), got[1:], ref[1:]):
            ch.compare(row, f'{case} {what} vs twin (exact)', g, r, 0.0)
        del got, ref


def run_batched_smoke(ch, tag=f'batched-smoke-{BATCH_SMOKE_N}x{BATCH_B}', N=BATCH_SMOKE_N, B=BATCH_B, warmup=2,
                      steps=5, check_steps=2, tol=1e-5):
    """9b: SmokePlume(N, dims=3, batch_shape=batch(b=B)) from B distinct smooth states (`smooth_state`, seeds
    0..B−1), its Field `step` (per-phase: JAX's gate refuses batch dims). Its first warm-up step records the
    inputs of its first CG matvec and K6 lookups, and the batched K1 and K6 are held to their twins on them
    (`check_batched_path_kernels`). Then `warmup` + `steps` timed with the
    counters set to 0 just before and read just after: ms/step, Mcells/s over all entries, CG iterations,
    launches a step by kernel (K6 exactly 5 a step, one a lookup for the batch), `max_memory_allocated`; the
    device's busy share from torch.profiler over 3 more steps. Then from the states again, `check_steps` steps
    batched against each entry's own unbatched Field step: within `tol` of each array's max, the batched CG
    count the largest of the entries' at every step, and the batched launches a step those of the unbatched
    per-phase path at the batched run's CG counts (per V-cycle and per CG iteration as unbatched, never B
    times them). Last, entry 0's unbatched Field step timed and profiled as the batched one was (B × its
    ms/step is the cost of running the entries one after another)."""
    import numpy as np
    import torch
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.math import batch
    from phiflow_tpu_torch.math import _nd
    from phiflow_tpu_torch.models import SmokePlume
    from phiflow_tpu_torch.ops import _build
    from phiflow_tpu_torch.physics import fluid
    states = [smooth_state(N, 3, seed=k) for k in range(B)]
    model = SmokePlume(resolution=N, dims=3, cg_tol=1e-3, max_iterations=100, batch_shape=batch(b=B), device='cuda')
    step, _ = _stepper(model, True)
    v, s, p = model.state_fields(*_stack_states(states))
    assert not model._fused_advect_available(v, s)
    with Recorder(_keep_batched_calls, poisson_apply=fluid, window_interp_3d=_nd) as rec:
        v, s, p = step(v, s, p)
    check_batched_path_kernels(ch, tag, rec.kept)
    del rec
    torch.cuda.empty_cache()
    for _ in range(warmup - 1):
        v, s, p = step(v, s, p)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    with math.SolveTape() as tape:
        t0 = time.perf_counter()
        for _ in range(steps):
            v, s, p = step(v, s, p)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES, steps=steps)
    iters = [info.iterations for info in tape]
    memory = torch.cuda.max_memory_allocated()
    ms = elapsed / steps * 1e3
    print(f'{tag} {B} x {N}^3: {ms:.2f} ms/step, {B * N ** 3 / (ms * 1e-3) / 1e6:.1f} Mcells/s over all entries, '
          f'{steps} Field steps after {warmup} warm-up steps; CG iterations per step {iters}; '
          f'max_memory_allocated {memory / 2 ** 30:.2f} GiB')
    print(f'{tag} launches per step: ' + ', '.join(f'{k}={launches.get(k, 0) / steps:g}' for k in KERNELS))
    missing = [k for k in PHASES_3D_KERNELS if launches.get(k, 0) == 0]
    wrong = {}
    if launches.get('window_interp_3d', 0) != K6_LAUNCHES_PER_PHASE_STEP * steps:
        wrong['window_interp_3d'] = (launches.get('window_interp_3d', 0), K6_LAUNCHES_PER_PHASE_STEP * steps)
    if launches.get('jacobi_sweeps', 0) != K2_LAUNCHES_PER_LEVEL * smoothed_levels(N) * sum(1 + it for it in iters):
        wrong['jacobi_sweeps'] = (launches.get('jacobi_sweeps', 0),
                                  K2_LAUNCHES_PER_LEVEL * smoothed_levels(N) * sum(1 + it for it in iters))
    vel, smoke, pressure = model.state_natives(v, s, p)
    finite = all(bool(torch.isfinite(t).all()) for t in (*vel, smoke, pressure))
    shapes_ok = tuple(smoke.shape) == (B,) + (N,) * 3 == tuple(pressure.shape)
    if missing or wrong or not finite or not shapes_ok:
        raise RuntimeError(f'{tag}: not launched {missing}, launches (counted, expected) {wrong}, finite {finite}, '
                           f'shapes {tuple(smoke.shape)} {tuple(pressure.shape)}')
    profile_path(tag, f'{B} x {N}^3', lambda st: step(*st), (v, s, p), warmup=0, steps=3)
    del v, s, p, vel, smoke, pressure
    torch.cuda.empty_cache()
    # each entry against its own unbatched step
    vb, sb, pb = model.state_fields(*_stack_states(states))
    _build.reset_launches()
    with math.SolveTape() as tape:
        for _ in range(check_steps):
            vb, sb, pb = step(vb, sb, pb)
    torch.cuda.synchronize()
    batched_launches, batched_iters = dict(_build.LAUNCHES), [i.iterations for i in tape]
    batched = model.state_natives(vb, sb, pb)
    del vb, sb, pb
    single = SmokePlume(resolution=N, dims=3, cg_tol=1e-3, max_iterations=100, device='cuda')
    from phiflow_tpu_torch.models import state_from_numpy
    worst, entry_iters, per_cycle = 0.0, [], None
    for e, st in enumerate(states):
        out, its, lnch = _unbatched_launches(single, state_from_numpy(*st, device='cuda'), check_steps)
        entry_iters.append(its)
        cycles = sum(1 + it for it in its)
        rates = {k: lnch.get(k, 0) / cycles for k in ('jacobi_sweeps', 'residual_restrict', 'prolong_add')}
        rates['poisson_stencil'] = lnch.get('poisson_stencil', 0) / cycles  # A·x0 and one an iteration
        rates['window_interp_3d'] = lnch.get('window_interp_3d', 0) / check_steps
        per_cycle = per_cycle or rates
        if rates != per_cycle:
            raise RuntimeError(f'{tag}: unbatched launches a V-cycle differ between entries: {rates} vs {per_cycle}')
        errs = []
        for got, ref in zip(_tensors(batched), _tensors(out)):
            errs.append(float((got[e] - ref).abs().max()) / max(float(ref.abs().max()), 1e-30))
        print(f'{tag} entry {e} (seed {e}) vs its unbatched Field step, {check_steps} steps: max |diff| / max |ref| '
              + ', '.join(f'{x:.2e}' for x in errs) + f'; CG iterations {its}')
        worst = max(worst, max(errs))
        del out
    max_iters = [max(its[k] for its in entry_iters) for k in range(check_steps)]
    cycles = sum(1 + it for it in batched_iters)
    expected = {k: r * (cycles if k != 'window_interp_3d' else check_steps) for k, r in per_cycle.items()}
    wrong = {k: (batched_launches.get(k, 0), e) for k, e in expected.items() if batched_launches.get(k, 0) != e}
    ok = worst <= tol and batched_iters == max_iters and not wrong
    print(f'{tag} batched vs unbatched: max relative diff {worst:.2e} (tol {tol:.0e}; bit-equal: {worst == 0.0}); '
          f'batched CG {batched_iters}, '
          f'largest of the entries {max_iters}; launches over {check_steps} steps (batched, unbatched path at the '
          f'same CG counts): ' + ', '.join(f'{k}={batched_launches.get(k, 0)}/{e:g}' for k, e in expected.items())
          + f': {"ok" if ok else "FAIL"}')
    if not ok:
        raise RuntimeError(f'{tag}: batched step disagrees with the unbatched ones: {worst}, CG {batched_iters} vs '
                           f'{max_iters}, launches (batched, expected) {wrong}')
    single_step, _ = _stepper(single, True)
    st = single.state_fields(*state_from_numpy(*states[0], device='cuda'))
    for _ in range(warmup):
        st = single_step(*st)
    torch.cuda.synchronize()
    with math.SolveTape() as tape:
        t0 = time.perf_counter()
        for _ in range(steps):
            st = single_step(*st)
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t0) / steps * 1e3
    print(f'{tag} entry 0 alone (unbatched Field step, 1 x {N}^3): {one_ms:.2f} ms/step, CG iterations per step '
          f'{[i.iterations for i in tape]}; {B} entries one after another {B * one_ms:.2f} ms/step, batched '
          f'{ms:.2f} ms/step ({B * one_ms / ms:.2f}x)')
    profile_path(f'{tag} entry 0 alone', f'1 x {N}^3', lambda x: single_step(*x), st, warmup=0, steps=3)
    del st
    torch.cuda.empty_cache()
    return launches


def batched_smoke_recipe(device, N=BATCH_RECIPE_N, steps=BATCH_RECIPE_STEPS, rates=BATCH_RATES):
    """examples/batched_smoke.py's recipe in the port: a batch dim of inflow rates through MacCormack, buoyancy,
    semi-Lagrangian self-advection and the projection (CG 1e-3), `steps` steps on `device`. Returns the smoke
    (inflow_rate, x, y) as numpy and the total smoke of each entry."""
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.field import CenteredGrid, StaggeredGrid, resample
    from phiflow_tpu_torch.geom import Box, Sphere
    from phiflow_tpu_torch.math import ConvergenceException, Solve, batch, extrapolation, wrap
    from phiflow_tpu_torch.physics import advect, fluid
    with math.default_device(device):
        bounds = Box(x=float(N), y=float(N))
        rate = wrap(list(rates), batch('inflow_rate'))
        velocity = StaggeredGrid(0.0, extrapolation.ZERO, x=N, y=N, bounds=bounds)
        smoke = CenteredGrid(0.0, extrapolation.ZERO_GRADIENT, x=N, y=N, bounds=bounds)
        inflow = resample(Sphere(x=N / 2, y=6, radius=4), to=smoke, soft=True) * rate
        dt = 1.0
        for _ in range(steps):
            smoke = advect.mac_cormack(smoke, velocity, dt) + dt * inflow
            buoyancy = resample(smoke * (0.0, 0.1), to=velocity)
            velocity = advect.semi_lagrangian(velocity, velocity, dt) + dt * buoyancy
            velocity, _ = fluid.make_incompressible(velocity, (), Solve('CG', 1e-3, 0.,
                                                                         suppress=(ConvergenceException,)))
        values = smoke.values.numpy(('inflow_rate', 'x', 'y'))
    return values, values.sum(axis=(1, 2))


def run_batched_recipe(tag='batched-smoke-2d', tol=1e-3):
    """9c: examples/batched_smoke.py's recipe at its own 64² with four inflow rates, 30 steps, on the card (K7,
    the 2D projection in PyTorch; K7 exactly 4 launches a step, one a lookup for the batch) and on the CPU: the
    example's assert (stronger inflow holds more smoke) on both, card against CPU within `tol` of the smoke's
    largest value (the recipe's smoke grows to tens, where the other CPU-vs-card gates hold fields of order 1
    at 1e-3 absolute). Beside it, how far rounding alone moves the recipe: the CPU run again with each inflow
    rate one float32 ulp up, against the CPU run."""
    import numpy as np
    import torch
    from phiflow_tpu_torch.ops import _build
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    card, totals = batched_smoke_recipe('cuda')
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / BATCH_RECIPE_STEPS * 1e3
    launches = dict(_build.LAUNCHES, steps=BATCH_RECIPE_STEPS)
    cpu, cpu_totals = batched_smoke_recipe('cpu')
    ulp_up = tuple(float(np.nextafter(np.float32(r), np.float32(np.inf))) for r in BATCH_RATES)
    rounding = float(np.abs(batched_smoke_recipe('cpu', rates=ulp_up)[0] - cpu).max())
    err = float(np.abs(card - cpu).max())
    scale = float(np.abs(cpu).max())
    monotone = all(a < b for a, b in zip(totals, totals[1:])) and all(a < b for a, b in zip(cpu_totals,
                                                                                             cpu_totals[1:]))
    k7 = launches.get('window_interp_2d', 0)
    ours = {k: v for k, v in launches.items() if k in KERNELS and v}
    ok = monotone and err <= tol * scale and k7 == 4 * BATCH_RECIPE_STEPS and set(ours) == {'window_interp_2d'}
    print(f'{tag} {len(BATCH_RATES)} x {BATCH_RECIPE_N}^2, {BATCH_RECIPE_STEPS} steps: {ms:.2f} ms/step (first run, '
          f'host clock); total smoke per entry {[round(float(t), 1) for t in totals]} (CPU '
          f'{[round(float(t), 1) for t in cpu_totals]}): stronger inflow holds more: {monotone}; card vs CPU max '
          f'|diff| {err:.2e} of a largest value {scale:.3e}: {err / scale:.2e} (tol {tol:.0e}); CPU with the rates one '
          f'float32 ulp up vs CPU max |diff| {rounding:.2e}; launches {ours}: {"ok" if ok else "FAIL"}')
    if not ok:
        raise RuntimeError(f'{tag}: monotone {monotone}, card vs CPU {err}, launches {ours}')
    return launches


def batched_cpu_vs_card(N=32, B=3, steps=2, tol=1e-3):
    """9d: SmokePlume(N, dims=3, batch_shape=batch(b=B)) from B distinct smooth states, `steps` Field steps on
    the CPU (the twins) and on the card (the kernels), within `tol`."""
    import numpy as np
    from phiflow_tpu_torch.math import batch
    from phiflow_tpu_torch.models import SmokePlume, state_from_numpy
    states = [smooth_state(N, 3, seed=k) for k in range(B)]
    arrays = [np.stack(parts) for parts in zip(*states)]
    out = {}
    for dev in ('cpu', 'cuda'):
        model = SmokePlume(resolution=N, dims=3, cg_tol=1e-3, max_iterations=100, batch_shape=batch(b=B), device=dev)
        step, _ = _stepper(model, True)
        v, s, p = model.state_fields(*state_from_numpy(*arrays, device=dev))
        for _ in range(steps):
            v, s, p = step(v, s, p)
        out[dev] = [t.detach().cpu().numpy() for t in _tensors(model.state_natives(v, s, p))]
    errs = [float(np.abs(a - b).max()) for a, b in zip(out['cpu'], out['cuda'])]
    worst = max(errs)
    print(f'cpu vs card, batched-smoke {B} x {N}^3, {steps} steps from {B} numpy states: '
          + ', '.join(f'{e:.2e}' for e in errs) + f'; max {worst:.2e} tol {tol:.0e} {"ok" if worst <= tol else "FAIL"}')
    if not worst <= tol:
        raise RuntimeError(f'CPU and card disagree (batched smoke): {errs}')


def run_batched_gradient(tag, dims, N, B=2, steps=1, tol=1e-4):
    """9e: the gradient of a batched rollout (`_smoke_grad`, L summed over the entries) with respect to the
    batched initial velocity and smoke, on the card: K6ᵀ (K7ᵀ) once for each K6 (K7) launch of the forward, one
    a lookup for the batch; each entry's gradient within `tol` of its scale of that entry's own unbatched
    gradient."""
    import torch
    from phiflow_tpu_torch.math import batch
    from phiflow_tpu_torch.models import SmokePlume, state_from_numpy
    from phiflow_tpu_torch.ops import _build
    states = [smooth_state(N, dims, seed=k) for k in range(B)]
    vb, sb, _ = _stack_states(states)
    w = _smooth_weight(N, dims).cuda()
    model = SmokePlume(resolution=N, dims=dims, cg_tol=GRAD_CG_TOL, max_iterations=300, batch_shape=batch(b=B),
                       device='cuda')
    record = {}
    _build.reset_launches()
    _, gvel, gsmoke = _smoke_grad(model, (vb, sb), w, steps, record)
    torch.cuda.synchronize()
    forward, backward = record['forward'], dict(_build.LAUNCHES)
    k6 = f'window_interp_{dims}d'
    single = SmokePlume(resolution=N, dims=dims, cg_tol=GRAD_CG_TOL, max_iterations=300, device='cuda')
    worst = 0.0
    for e, st in enumerate(states):
        ve, se, _ = state_from_numpy(*st, device='cuda')
        _, gv1, gs1 = _smoke_grad(single, (ve, se), w, steps)
        for got, ref in zip(gvel + [gsmoke], gv1 + [gs1]):
            worst = max(worst, float((got[e] - ref).abs().max()) / max(float(ref.abs().max()), 1e-30))
    ok = (backward.get(k6 + '_grad', 0) == forward.get(k6, 0) > 0 and worst <= tol
          and all(g.shape[0] == B for g in gvel + [gsmoke]))
    print(f'{tag} {B} x {N}^{dims}, {steps} step: math.gradient of the summed loss; launches forward '
          f'{k6}={forward.get(k6, 0)}, backward {k6}_grad={backward.get(k6 + "_grad", 0)}; each entry vs its own '
          f'unbatched gradient: max |diff| / max |ref| {worst:.2e} (tol {tol:.0e}): {"ok" if ok else "FAIL"}')
    if not ok:
        raise RuntimeError(f'{tag}: launches forward {forward}, backward {backward}, entries {worst}')
    return dict({k: forward.get(k, 0) + backward.get(k, 0) for k in KERNELS}, steps=steps)


BATCH_OBSTACLE_N, BATCH_OBSTACLE_B = 256, 4  # 9f batched-obstacle-256x4: four states around one geometry
BATCH_OBSTACLE_VCYCLE = (128, 2)             # and batched-obstacle-128x2-vcycle under the projected V-cycle


def run_batched_obstacles(tag, N, B, preconditioner='chebyshev', warmup=2, steps=3):
    """9f: the obstacle step of 4f (`obstacle_stepper`: obstacle-256's three obstacles, moving, shared by the
    batch; cg_tol 1e-4, at most 500 iterations) on B velocity states at once, from `smooth_state(N)` with seeds
    0..B−1, `warmup` + `steps` steps, the counters set to 0 just before the timed ones and read just after.
    Prints ms/step, Mcells/s over all entries, the CG iterations of each entry (from its own unbatched steps),
    launches a step, `max_memory_allocated` above what was allocated before, and a profiled step (device ms,
    kernels, busy share). Gates: each entry's velocity and pressure bit-equal to its own unbatched obstacle steps
    from the same state; K1m launched in the timed steps as often as the entry that iterates longest launches it
    in each (one launch for the batch); max |div·active − mean| of each entry within `OBSTACLE_DIV_BOUND`;
    finite state."""
    import torch
    from phiflow_tpu_torch.field import cell_grid, divergence_native, geometry_mask
    from phiflow_tpu_torch.geom import union
    from phiflow_tpu_torch.ops import _build
    step = obstacle_stepper(N, preconditioner=preconditioner)[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state = obstacle_state(N, 'cuda', seeds=range(B))
    start = state
    for _ in range(warmup):
        state, _ = step(*state)
    torch.cuda.synchronize()
    _build.reset_launches()
    results = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, result = step(*state)
        results.append(result)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    launches = dict(_build.LAUNCHES, steps=steps)
    peak = torch.cuda.max_memory_allocated() - base
    # each entry on its own, from the same state: its iterations and launches a step, and its final state
    counter = 'poisson_stencil_masked'
    iters, k1m = [], []
    for e in range(B):
        own = (tuple(c[e].clone() for c in start[0]), start[1][e].clone(), *start[2:])
        for _ in range(warmup):
            own, _ = step(*own)
        its, counts = [], []
        for _ in range(steps):
            before = _build.LAUNCHES[counter]
            own, r = step(*own)
            its.append(r.iterations)
            counts.append(_build.LAUNCHES[counter] - before)
        iters.append(its)
        k1m.append(counts)
        same = all(torch.equal(a[e], b) for a, b in zip((*state[0], state[1]), (*own[0], own[1])))
        if not same:
            raise RuntimeError(f'{tag}: entry {e} differs from its own unbatched steps')
        del own
    longest = sum(max(k1m[e][i] for e in range(B)) for i in range(steps))
    print(f'{tag} {B} x {N}^3: {ms:.2f} ms/step, {B * N ** 3 / (ms * 1e-3) / 1e6:.1f} Mcells/s over all entries, '
          f'{steps} steps after {warmup} warm-up; CG iterations of the batched solve a step '
          f'{[r.iterations for r in results]}, each entry\'s own {iters} (MASKED_PRECONDITIONER {preconditioner!r}, '
          f'cg_tol 1e-4); max_memory_allocated {peak / 2 ** 30:.2f} GiB above the {base / 2 ** 30:.2f} GiB allocated '
          f'before; each entry bit-equal to its own unbatched steps: ok')
    print(f'{tag} launches per step: ' + ', '.join(f'{k}={launches.get(k, 0) / steps:g}' for k in KERNELS)
          + f'; {counter} in the timed steps {launches.get(counter, 0)}, the longest entry\'s {longest} '
          f'(entries {[sum(c) for c in k1m]})')
    if launches.get(counter, 0) != longest or launches.get('window_interp_3d', 0) != K6_LAUNCHES_PER_OBSTACLE_STEP * steps:
        raise RuntimeError(f'{tag}: {counter} {launches.get(counter, 0)} launches against the longest entry\'s '
                           f'{longest}; window_interp_3d {launches.get("window_interp_3d", 0)}')
    v, p, *obstacles = state
    accessible = geometry_mask(~union([o.geometry for o in obstacles]), cell_grid((N,) * 3, 1.0, 'cuda'))
    div = divergence_native(v, 1.0) * accessible
    dev = []
    for e in range(B):
        balance = div[e].sum() / accessible.sum()
        dev.append(float(((div[e] - balance) * accessible).abs().max()))
    finite = all(bool(torch.isfinite(t).all()) for t in (*v, p))
    bound = OBSTACLE_DIV_BOUND[preconditioner]
    print(f'{tag} after projection max |div·active − its mean| by entry {[f"{x:.3e}" for x in dev]} (bound '
          f'{bound:.0e}); all finite: {finite}; max |v| {max(float(c.abs().max()) for c in v):.3f}')
    if not (finite and max(dev) < bound):
        raise RuntimeError(f'{tag} output wrong: finite={finite} div={dev}')
    del start, v, p, div
    profile_path(tag, f'{B} x {N}^3', lambda st: step(*st)[0], state, warmup=0, steps=1, rows_shown=6)
    del state
    return launches


def run_batched(ch, gen):
    """Phase 9: batched simulation. 9a runs with the kernel checks (phase 3); 9b–9f here."""
    import torch
    part = PhaseClock('part of phase')
    by_path = {f'batched-smoke-{BATCH_SMOKE_N}x{BATCH_B}': run_batched_smoke(ch)}
    torch.cuda.empty_cache()
    part.done(f'9b batched-smoke-{BATCH_SMOKE_N}x{BATCH_B}')
    by_path[f'batched-smoke-{BATCH_WIDE_N}x{BATCH_WIDE_B}'] = run_batched_smoke(
        ch, f'batched-smoke-{BATCH_WIDE_N}x{BATCH_WIDE_B}', BATCH_WIDE_N, BATCH_WIDE_B)
    torch.cuda.empty_cache()
    part.done(f'9b batched-smoke-{BATCH_WIDE_N}x{BATCH_WIDE_B}')
    by_path['batched-smoke-2d'] = run_batched_recipe()
    batched_cpu_vs_card()
    part.done('9c-9d')
    by_path['batched-grad-64'] = run_batched_gradient('batched-grad-64', 3, 64)
    by_path['batched-grad-256-2d'] = run_batched_gradient('batched-grad-256-2d', 2, 256)
    torch.cuda.empty_cache()
    part.done('9e')
    tag = f'batched-obstacle-{BATCH_OBSTACLE_N}x{BATCH_OBSTACLE_B}'
    by_path[tag] = run_batched_obstacles(tag, BATCH_OBSTACLE_N, BATCH_OBSTACLE_B, warmup=1, steps=2)
    torch.cuda.empty_cache()
    part.done(f'9f {tag}')
    n, b = BATCH_OBSTACLE_VCYCLE
    tag = f'batched-obstacle-{n}x{b}-vcycle'
    by_path[tag] = run_batched_obstacles(tag, n, b, preconditioner='vcycle')
    torch.cuda.empty_cache()
    part.done(f'9f {tag}')
    return by_path


# ---------------------------------------------------------------------------
# phase 10: open and mixed boundaries
OPEN_N = 256             # 10a open-plume-256: SmokePlume(256, dims=3)'s configuration with an open top
OPEN_WARMUP, OPEN_STEPS = 2, 3
OPEN_TUNNEL_DT = 1 / 256  # 10b: half a cell along x at the inflow speed 1 (cells 1/128 long)
WAKE_RES, WAKE_STEPS = (128, 64), 120  # examples/wake_flow.py
VARIABLE_STEPS = 12      # examples/variable_boundaries.py
OPEN_CASES_N = {3: 64, 2: 256}  # 10d: the Field cases on the card against the CPU
OPEN_CASE_TOL, OPEN_STEP_TOL = 1e-4, 1e-3
OPEN_SIDE_RULES = ('SYMMETRIC', 'REFLECT', 'ANTISYMMETRIC', 'ANTIREFLECT', 'SYMMETRIC_GRADIENT')


def _open_step(model, inflow, solve):
    """One smoke step through the Field API, as `SmokePlume.step` writes it per phase: MacCormack smoke plus
    the inflow, the velocity's semi-Lagrangian self-advection, buoyancy on the top component (none where
    `model.buoyancy` is 0), `make_incompressible` with `solve` (x0 the last pressure)."""
    from phiflow_tpu_torch.field import resample
    from phiflow_tpu_torch.math import Solve, dual, stack
    from phiflow_tpu_torch.physics import advect, fluid

    def step(v, s, p):
        names = v.resolution.names
        s = advect.mac_cormack(s, v, model.dt, max_cells=model.max_cells) + inflow
        v = advect.semi_lagrangian(v, v, model.dt, max_cells=model.max_cells)
        if model.buoyancy:
            up = names[-1]
            lift = resample(s * (model.buoyancy * model.dt), to=v.vector[up])
            v = v.with_values(stack([v.vector[d].values + lift.values if d == up else v.vector[d].values
                                     for d in names], dual(vector=names)))
        v, p = fluid.make_incompressible(v, (), Solve(solve.method, solve.rel_tol, solve.abs_tol, x0=p,
                                                      max_iterations=solve.max_iterations,
                                                      suppress=solve.suppress))
        return v, s, p
    return step


def _open_values(template, arrays):
    """`template` (a staggered grid) with the face arrays `arrays` (closed-box interior faces, torch) grown to
    the faces its boundary stores by repeating the outermost ones."""
    import torch
    from phiflow_tpu_torch import math
    names = template.resolution.names
    comps = []
    for a, (d, arr) in enumerate(zip(names, arrays)):
        n = template.vector[d].values.shape.get_size(d)
        lo, up = template.boundary.valid_outer_faces(d)
        parts = ([arr.narrow(a, 0, 1)] if lo else []) + [arr] + ([arr.narrow(a, arr.shape[a] - 1, 1)] if up else [])
        grown = torch.cat(parts, dim=a)
        assert grown.shape[a] == n, (d, tuple(grown.shape), n)
        comps.append(math.wrap(grown.contiguous(), math.spatial(*names)))
    return template.with_values(math.stack(comps, math.dual(vector=names)))


def _keep_open_calls(name, args, kwargs, kept):
    """`Recorder`'s keep for an open-boundary step: the first CG matvec with its dot on a nonzero direction
    (K1's arguments) and the first window lookup of each grid shape, with or without extrema (its arguments)."""
    if name == 'poisson_apply':
        return {name: (args, kwargs)} if kwargs.get('with_dot') and name not in kept and bool(args[0].any()) else {}
    return {(name, tuple(args[0].shape), bool(kwargs.get('compute_extrema'))): (args, kwargs)}


def check_open_path_kernels(ch, tag, kept):
    """K1 and K6 / K7 against their twins on the inputs an open-boundary step gave them (`_keep_open_calls`):
    phase 3's tolerances — K1 2e-5 on the system scaled by a power of two as `check_tunnel_stencil` scales it,
    its dot 1e-5; the window lookups 1e-5, lo / up exactly (the padded grids of the mixed boundaries, mode
    None, the const and edge halos)."""
    from phiflow_tpu_torch.ops import interp as I
    from phiflow_tpu_torch.ops import poisson as P
    if 'poisson_apply' in kept:
        (p, inv_dx2, bcs), kw = kept.pop('poisson_apply')
        s = pow2(float(p.std()) * sum(inv_dx2) / 3)
        case = f'{tag} CG matvec +dot {tuple(p.shape)} {bcs}'
        got, dot = P.poisson_apply(p, inv_dx2, bcs, **kw)
        ref, rdot = P._poisson_apply_plain(p, inv_dx2, bcs, **kw)
        ch.compare('poisson_stencil', f'{case} (÷ {s:g})', got / s, ref / s, 2e-5)
        ch.compare_dot('poisson_stencil', f'{case} dot', dot, rdot, 1e-5)
        del got, ref
    modes = []
    for (row, shape, extrema), ((grid, disps, K), kw) in kept.items():
        mode = 'const' if kw.get('const_pad') is not None else kw.get('halo')
        modes.append(mode or 'padded')
        sgn = -1.0 if kw.get('negate') else 1.0
        d = len(disps)
        scale = tuple(I._f32(sgn * x) for x in (kw.get('disp_scale') or (1.0,) * d))
        case = f'{tag} lookup {shape} {mode or "padded"}{" extrema" if extrema else ""}'
        got = getattr(I, row)(grid, disps, K, **kw)
        ref = I._window_interp_plain(grid, list(disps), K, extrema, scale, mode, I._f32(kw.get('const_pad') or 0.0))
        got, ref = (got, ref) if extrema else ((got,), (ref,))
        ch.compare(row, case + ' value vs twin', got[0], ref[0], 1e-5)
        for what, g, r in zip(('lo', 'up'), got[1:], ref[1:]):
            ch.compare(row, f'{case} {what} vs twin (exact)', g, r, 0.0)
        del got, ref
    return modes


def _open_launch_gates(tag, launches, iters, steps, shape, k6_row):
    """The exact launches of `steps` open-boundary steps: the window lookups 5 a step (the smoke's MacCormack
    pair and one per velocity component), K1 one a CG iteration and one a solve, K2 two per smoothed level a
    V-cycle, K3 and K4 a whole number a V-cycle (the projection's V-cycle preconditions a solve a V-cycle an
    iteration from 16 cells along an axis), nothing else of ours."""
    k1 = sum(1 + it for it in iters)
    check_launches(tag, launches, k1, k1 if max(shape) >= 16 else 0, shape)
    if launches.get(k6_row, 0) != K6_LAUNCHES_PER_PHASE_STEP * steps:
        raise RuntimeError(f'{tag}: {k6_row} {launches.get(k6_row, 0)}, expected {K6_LAUNCHES_PER_PHASE_STEP * steps}')
    others = {k: c for k, c in launches.items() if k in KERNELS and c and k not in PHASES_3D_KERNELS}
    if others:
        raise RuntimeError(f'{tag}: other kernels launched: {others}')


def run_open_path(ch, tag, model, fields, inflow, solve, size, cells, warmup=OPEN_WARMUP, steps=OPEN_STEPS):
    """10a / 10b: `warmup` + `steps` steps of `_open_step` from `fields` (v, s, p): the last warm-up step
    records the inputs of its first CG matvec and window lookups (the tunnel's smoke is 0 before its first
    step) and K1 / K6 are held to their twins on them (`check_open_path_kernels`); then ms/step, Mcells/s,
    CG iterations, launches a step (exact:
    `_open_launch_gates`), `max_memory_allocated`, finite values, and the busy share and device kernels a step
    under torch.profiler."""
    import torch
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.math import _nd
    from phiflow_tpu_torch.ops import _build
    from phiflow_tpu_torch.physics import fluid
    step = _open_step(model, inflow, solve)
    v, s, p = fields
    for _ in range(warmup - 1):
        v, s, p = step(v, s, p)
    failed = len(ch.failed)
    with Recorder(_keep_open_calls, poisson_apply=fluid, window_interp_3d=_nd) as rec:
        v, s, p = step(v, s, p)
    modes = check_open_path_kernels(ch, tag, rec.kept)
    del rec
    if len(ch.failed) > failed or 'padded' not in modes:
        raise RuntimeError(f'{tag}: kernels against their twins {ch.failed[failed:]}, lookup modes {modes}')
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    with math.SolveTape() as tape:
        t0 = time.perf_counter()
        for _ in range(steps):
            v, s, p = step(v, s, p)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES, steps=steps)
    iters = [info.iterations for info in tape]
    memory = torch.cuda.max_memory_allocated()
    ms = elapsed / steps * 1e3
    names = v.resolution.names
    arrays = [v.vector[d].values.torch(names) for d in names] + [s.values.torch(names), p.values.torch(names)]
    finite = all(bool(torch.isfinite(a).all()) for a in arrays)
    print(f'10 {tag} {size}: {ms:.2f} ms/step, {cells / (ms * 1e-3) / 1e6:.1f} Mcells/s, {steps} Field steps after '
          f'{warmup} warm-up steps; CG iterations per step {iters}; max_memory_allocated {memory / 2 ** 30:.2f} GiB; '
          f'face counts {[tuple(a.shape) for a in arrays[:len(names)]]}; lookups {sorted(set(modes))}; all finite: '
          f'{finite}')
    print(f'10 {tag} launches per step: ' + ', '.join(f'{k}={launches.get(k, 0) / steps:g}' for k in KERNELS))
    _open_launch_gates(tag, launches, iters, steps, tuple(v.resolution.sizes), 'window_interp_3d')
    if not finite:
        raise RuntimeError(f'{tag}: non-finite values')
    profile_path(tag, size, lambda st: step(*st), (v, s, p), warmup=0, steps=3)
    del v, s, p, arrays
    torch.cuda.empty_cache()
    return launches


def open_plume(N=OPEN_N, device='cuda'):
    """10a's model and fields: SmokePlume(N, dims=3)'s inflow sphere, buoyancy, dt and cg_tol 1e-3, the velocity
    under combine_sides(x=0, y=0, z=(0, ZERO_GRADIENT)) (walls, an open top) from `smooth_state`'s velocity, the
    smoke ZERO_GRADIENT from its smoke, the pressure 0 under the derived extrapolation."""
    import torch
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.field import CenteredGrid, StaggeredGrid
    from phiflow_tpu_torch.math import ConvergenceException, Solve, extrapolation
    from phiflow_tpu_torch.models import SmokePlume
    from phiflow_tpu_torch.physics import fluid
    model = SmokePlume(resolution=N, dims=3, cg_tol=1e-3, max_iterations=100, device=device)
    *vel, smoke, _ = smooth_state(N, 3)
    bounds = model.smoke0.bounds
    res = dict(x=N, y=N, z=N)
    zg = extrapolation.ZERO_GRADIENT
    with math.default_device(device):
        v = _open_values(StaggeredGrid(0., extrapolation.combine_sides(x=0, y=0, z=(0, zg)), bounds=bounds, **res),
                         [torch.from_numpy(a).to(device) for a in vel])
        s = CenteredGrid(math.wrap(torch.from_numpy(smoke).to(device), math.spatial('x,y,z')), zg, bounds=bounds,
                         **res)
        p = CenteredGrid(0., fluid._pressure_extrapolation(v.boundary), bounds=bounds, **res)
        inflow = s.with_values(math.wrap(model._inflow_mask_values_native(s.values.torch(('x', 'y', 'z')))
                                         * model.inflow_rate, math.spatial('x,y,z')))
    solve = Solve('CG', model.cg_tol, 0., max_iterations=model.max_iterations, suppress=(ConvergenceException,))
    return model, (v, s, p), inflow, solve


def open_tunnel(device='cuda', res=TUNNEL_RES):
    """10b's model and fields: 8c's Box(x=4, y=1, z=1) at `res` cells with no obstacle, the inflow vec(x=1, y=0,
    z=0) at x−, ZERO_GRADIENT at x+, walls at rest in y and z; `_tunnel_velocity`'s flow, the smoke 0
    (ZERO_GRADIENT) with a source of 0.2 a step in the inflow's slab x < 0.25, 0.25 < y, z < 0.75; dt
    OPEN_TUNNEL_DT, no buoyancy, CG at 1e-3."""
    import types
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.field import CenteredGrid
    from phiflow_tpu_torch.geom import Box
    from phiflow_tpu_torch.math import ConvergenceException, Solve, extrapolation
    from phiflow_tpu_torch.physics import fluid
    zg = extrapolation.ZERO_GRADIENT
    boundary = extrapolation.combine_sides(x=(math.vec(x=1., y=0., z=0.), zg), y=0, z=0)
    with math.default_device(device):
        v = _tunnel_velocity(boundary) if res == TUNNEL_RES else _open_tunnel_velocity(boundary, res, device)
        dom = dict(bounds=Box(x=4, y=1, z=1), **dict(zip(('x', 'y', 'z'), res)))
        s = CenteredGrid(0., zg, **dom)
        inflow = CenteredGrid(Box(x=(0, 0.25), y=(0.25, 0.75), z=(0.25, 0.75)), 0., **dom) * 0.2
        p = CenteredGrid(0., fluid._pressure_extrapolation(v.boundary), **dom)
    model = types.SimpleNamespace(dt=OPEN_TUNNEL_DT, max_cells=1, buoyancy=0.)
    solve = Solve('CG', 1e-3, 0., max_iterations=100, suppress=(ConvergenceException,))
    return model, (v, s, p), inflow, solve


def _open_tunnel_velocity(boundary, res, device):
    """`_tunnel_velocity` at other cells than TUNNEL_RES (the CPU comparison's)."""
    import torch
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.field import StaggeredGrid
    from phiflow_tpu_torch.geom import Box
    names = ('x', 'y', 'z')
    template = StaggeredGrid(0., boundary, bounds=Box(x=4, y=1, z=1), **dict(zip(names, res)))
    comps = []
    for a, d in enumerate(names):
        shape = tuple(template.vector[d].values.shape.only(names, reorder=True).sizes)
        g = torch.meshgrid(*[torch.arange(n, dtype=torch.float32) / n for n in shape], indexing='ij')
        wave = torch.sin(2 * 3.141592653589793 * (g[0] + 2 * g[1] + 3 * g[2]) + a) * \
            torch.cos(2 * 3.141592653589793 * g[(a + 1) % 3])
        comps.append(((1.0 if d == 'x' else 0.0) + 0.1 * wave).to(device))
    return template.with_values(math.stack([math.wrap(c, math.spatial(*names)) for c in comps],
                                           math.dual(vector=names)))


def open_cpu_vs_card(tag, make, steps=2, tol=OPEN_STEP_TOL):
    """`steps` steps of `_open_step` from `make(device)`'s fields on the CPU and on the card, CG at 1e-5 (at the
    paths' 1e-3 two devices' roundings stop CG at different iterates, which the pressure shows): each field
    within `tol` of its scale, the CG counts printed."""
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.math import Solve, SolveTape
    outs, counts = [], []
    for dev in ('cuda', 'cpu'):
        model, fields, inflow, solve = make(dev)
        step = _open_step(model, inflow, Solve(solve.method, 1e-5, 1e-5, max_iterations=300,
                                               suppress=solve.suppress))
        v, s, p = fields
        with math.default_device(dev), SolveTape() as tape:
            for _ in range(steps):
                v, s, p = step(v, s, p)
        counts.append([(i.iterations, i.converged) for i in tape])
        names = v.resolution.names
        outs.append([v.vector[d].values.torch(names) for d in names] + [s.values.torch(names), p.values.torch(names)])
    errs = [_scale_err(a, b) for a, b in zip(*outs)]
    print(f'10 {tag} card vs CPU, {steps} steps: scaled errors (velocity components, smoke, pressure) '
          + ', '.join(f'{e:.2e}' for e in errs) + f' (tol {tol:.0e}); CG (iterations, converged) card {counts[0]}, '
          f'CPU {counts[1]}')
    if max(errs) > tol:
        raise RuntimeError(f'{tag} card vs CPU: {errs}')


def wake_flow(device, steps, res=WAKE_RES, cg_tol=1e-3):
    """`examples/wake_flow.py` through the port's public functions: inflow vec(x=1, y=0) at x−, open outflow at
    x+, ZERO_GRADIENT in y, a sphere obstacle; `steps` steps of its body (semi-Lagrangian self-advection, CG
    at `cg_tol`, the example's 1e-3, around the cylinder). Returns (velocity, pressure, the example's wake
    deficit)."""
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.field import StaggeredGrid
    from phiflow_tpu_torch.geom import Box, Sphere
    from phiflow_tpu_torch.math import ConvergenceException, Solve, extrapolation
    from phiflow_tpu_torch.physics import advect, fluid
    nx, ny = res
    with math.default_device(device):
        boundary = extrapolation.combine_sides(x=(math.vec(x=1.0, y=0.0), extrapolation.ZERO_GRADIENT),
                                               y=extrapolation.ZERO_GRADIENT)
        velocity = StaggeredGrid((1.0, 0.0), boundary, x=nx, y=ny, bounds=Box(x=float(nx), y=float(ny)))
        cylinder = fluid.Obstacle(Sphere(x=24, y=ny / 2 + 1, radius=6))
        pressure = None
        for _ in range(steps):
            velocity = advect.semi_lagrangian(velocity, velocity, 1.0)
            velocity, pressure = fluid.make_incompressible(velocity, (cylinder,), Solve(
                'CG', cg_tol, 0., x0=pressure, suppress=(ConvergenceException,)))
        u = velocity.at_centers().values[{'vector': 'x'}]
        wake = u.x[30:60].y[ny // 2 - 4:ny // 2 + 4]
        free = u.x[30:60].y[4:12]
        deficit = float(math.mean(free) - math.mean(wake))
    return velocity, pressure, deficit


def variable_boundaries(device, steps, cg_tol=1e-4):
    """`examples/variable_boundaries.py` through the port's public functions: a 64 × 32 channel whose inflow
    speed at x− oscillates, 1 + 0.5 sin(i / 2), set anew each step, CG at `cg_tol` (the example's 1e-4);
    returns (velocity, mean u_x)."""
    import numpy as np
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.field import StaggeredGrid
    from phiflow_tpu_torch.geom import Box
    from phiflow_tpu_torch.math import ConvergenceException, Solve, extrapolation
    from phiflow_tpu_torch.physics import advect, fluid
    domain = dict(x=64, y=32, bounds=Box(x=64, y=32))

    def make_velocity(speed):
        bc = {'x-': math.vec(x=speed, y=0.), 'x+': extrapolation.ZERO_GRADIENT, 'y': 0.}
        return StaggeredGrid(math.vec(x=speed, y=0.), bc, **domain)
    with math.default_device(device):
        values = make_velocity(1.0).values
        for i in range(steps):
            speed = float(np.float32(1.0 + 0.5 * np.sin(i * 0.5)))
            velocity = make_velocity(speed).with_values(values)
            velocity = advect.semi_lagrangian(velocity, velocity, 0.5)
            velocity, _ = fluid.make_incompressible(velocity, (), Solve('CG', cg_tol, cg_tol,
                                                                        suppress=(ConvergenceException,)))
            values = velocity.values
        vel = make_velocity(1.0).with_values(values)
        mean_ux = float(math.mean(vel.values[{'vector': 'x'}]))
    return vel, mean_ux


def _staggered_arrays(v):
    names = v.resolution.names
    return [v.vector[d].values.torch(names) for d in names]


def run_open_recipes(ch):
    """10c: examples/wake_flow.py's step at 128 × 64 for its 120 steps, its assert (wake deficit > 0.05) a gate,
    and examples/variable_boundaries.py's 12 steps, its assert (0.3 < mean u_x < 2, finite) a gate: ms/step,
    K7 launches a step (exactly 2: the velocity's two components) and nothing else of ours; K7 against its twin
    on the wake's first-step lookups (its padded inflow grids); 2 steps of each card against CPU within 1e-3
    of each field's scale, their solves at 1e-5 (converged: at the examples' tolerances the two devices'
    roundings stop CG at different iterates)."""
    import math as pymath
    import torch
    from phiflow_tpu_torch.math import _nd
    from phiflow_tpu_torch.ops import _build
    by_path = {}
    failed = len(ch.failed)
    with Recorder(_keep_open_calls, window_interp_2d=_nd) as rec:
        wake_flow('cuda', 1)
    modes = check_open_path_kernels(ch, 'wake-flow first step', rec.kept)
    if len(ch.failed) > failed or 'padded' not in modes:
        raise RuntimeError(f'wake-flow: K7 against its twin {ch.failed[failed:]}, lookup modes {modes}')
    for tag, run, steps in (('wake-flow-128x64', lambda: wake_flow('cuda', WAKE_STEPS), WAKE_STEPS),
                            ('variable-boundaries-64x32', lambda: variable_boundaries('cuda', VARIABLE_STEPS),
                             VARIABLE_STEPS)):
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3
        launches = dict(_build.LAUNCHES, steps=steps)
        ours = {k: c for k, c in launches.items() if k in KERNELS and c}
        v = out[0]
        finite = all(bool(torch.isfinite(a).all()) for a in _staggered_arrays(v))
        gate = out[2] > 0.05 if tag.startswith('wake') else (pymath.isfinite(out[1]) and 0.3 < out[1] < 2.0)
        value = f'wake deficit {out[2]:.3f} (> 0.05)' if tag.startswith('wake') else f'mean u_x {out[1]:.3f} (0.3–2)'
        ok = gate and finite and ours == {'window_interp_2d': 2 * steps}
        print(f'10c {tag}: {steps} steps, {ms:.2f} ms/step (host clock, first run); {value}; all finite: {finite}; '
              f'K7 {launches.get("window_interp_2d", 0) / steps:g} a step; launches {ours}: {"ok" if ok else "FAIL"}')
        if not ok:
            raise RuntimeError(f'{tag}: gate {gate}, finite {finite}, launches {ours}')
        by_path[tag] = launches
    for tag, run in (('wake-flow', lambda dev: wake_flow(dev, 2, cg_tol=1e-5)[:2]),
                     ('variable-boundaries', lambda dev: (variable_boundaries(dev, 2, cg_tol=1e-5)[0],))):
        card, cpu = run('cuda'), run('cpu')
        errs = []
        for got, ref in zip(card, cpu):
            if got.is_staggered:  # each component against the velocity's scale (v_y of the channel is about 0)
                scale = max(float(b.abs().max()) for b in _staggered_arrays(ref))
                errs += [float((a.cpu() - b).abs().max()) / scale for a, b in zip(_staggered_arrays(got),
                                                                                 _staggered_arrays(ref))]
            else:
                errs.append(_scale_err(got.values.torch(('x', 'y')), ref.values.torch(('x', 'y'))))
        print(f'10c {tag} 2 steps card vs CPU: errors of the velocity components and the pressure over their '
              f'field\'s scale ' + ', '.join(f'{e:.2e}' for e in errs) + f' (tol {OPEN_STEP_TOL:.0e})')
        if max(errs) > OPEN_STEP_TOL:
            raise RuntimeError(f'{tag} card vs CPU: {errs}')
    return by_path


def _open_case_fields(dims, device, rule=None):
    """10d's inputs on `device` from one numpy seed: a centred grid of OPEN_CASES_N[dims] cells under `rule`
    (an extrapolation's name; BOUNDARY without one), a closed-box staggered velocity of at most 0.8 cells a
    unit time, and a staggered velocity in an open box with an inflow wall."""
    import numpy as np
    import torch
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.field import CenteredGrid, StaggeredGrid
    from phiflow_tpu_torch.math import extrapolation
    N = OPEN_CASES_N[dims]
    names = ('x', 'y', 'z')[:dims]
    res = {n: N for n in names}
    rng = np.random.default_rng(dims)
    *vel, smoke, _ = smooth_state(N, dims, seed=3)
    with math.default_device(device):
        c = CenteredGrid(math.wrap(torch.from_numpy(smoke + 0.1 * rng.standard_normal(smoke.shape).astype(
            np.float32)).to(device), math.spatial(*names)), getattr(extrapolation, rule or 'BOUNDARY'), **res)
        closed = _open_values(StaggeredGrid(0., 0., **res), [torch.from_numpy(a * 0.66).to(device) for a in vel])
        inflow = extrapolation.combine_sides(**{names[0]: (math.vec(**{n: 1. if n == names[0] else 0.
                                                                         for n in names}),
                                                           extrapolation.ZERO_GRADIENT)},
                                             **{n: 0 for n in names[1:]})
        open_v = _open_values(StaggeredGrid(0., inflow, **res), [torch.from_numpy(a * 0.66).to(device) for a in vel])
    return c, closed, open_v


def _case_arrays(result):
    """The torch arrays of a Field, a Tensor or a tuple of them."""
    from phiflow_tpu_torch.field import Field
    if isinstance(result, tuple):
        return [a for r in result for a in _case_arrays(r)]
    if isinstance(result, Field):
        if result.is_staggered:
            labels = result.values.shape.get_labels('~vector')
            return [result.values[{'~vector': d}].torch(result.values[{'~vector': d}].shape.names) for d in labels]
        return [result.values.torch(result.values.shape.names)]
    return [result.torch(result.shape.names)]


def _case_on(device, fn, dims, rule):
    """`fn` of `_open_case_fields(dims, device, rule)` under `device` as the default device: its arrays."""
    from phiflow_tpu_torch import math
    with math.default_device(device):
        return _case_arrays(fn(*_open_case_fields(dims, device, rule)))


def run_open_cases(ch):
    """10d: the Field cases of the open-boundary slice on the card against the CPU at 64³ and 256², within
    1e-4 of each result's scale (1e-3 for advection steps): `laplace`, `resample` onto the closed box's faces,
    the face `spatial_gradient` and `mac_cormack` of a centred grid under each of OPEN_SIDE_RULES; slicing a
    centred and a staggered grid; `stagger(at='center')` and over a subset of the dims; `resample(order=4)`;
    `semi_lagrangian(substeps='auto')` at a CFL of about 3 with max_cells=1 (its substep count, the window
    lookups it launched and its device syncs); the gather lookups (`max_cells=None`); `rk4` on a grid; lookups
    at points of a staggered open box; and `math.gradient` of one open-box 2D step: K7ᵀ once for each forward
    K7 launch."""
    import torch
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.field import StaggeredGrid, laplace, resample, spatial_gradient, stagger
    from phiflow_tpu_torch.geom import Point
    from phiflow_tpu_torch.math import extrapolation
    from phiflow_tpu_torch.ops import _build
    from phiflow_tpu_torch.physics import advect
    cases = {}
    for dims in (3, 2):
        N = OPEN_CASES_N[dims]
        names = ('x', 'y', 'z')[:dims]
        for rule in OPEN_SIDE_RULES:
            for op, fn in (('laplace', lambda c, v, o: laplace(c)),
                           ('resample', lambda c, v, o: resample(c, to=StaggeredGrid(0., 0., c.bounds, c.resolution))),
                           ('face gradient', lambda c, v, o: spatial_gradient(c, at='face')),
                           ('mac_cormack', lambda c, v, o: advect.mac_cormack(c, v, 1.0))):
                cases[f'{dims}D {rule} {op}'] = (dims, rule, fn, OPEN_STEP_TOL if op == 'mac_cormack' else
                                                 OPEN_CASE_TOL)
        half = N // 2
        cases[f'{dims}D slice centred'] = (dims, None, lambda c, v, o, h=half: c.x[2:h].y[-h:], OPEN_CASE_TOL)
        cases[f'{dims}D slice staggered'] = (dims, None, lambda c, v, o, h=half: o.x[2:h], OPEN_CASE_TOL)
        cases[f'{dims}D stagger centres'] = (dims, None, lambda c, v, o: stagger(c, math.minimum, 0., at='center'),
                                             OPEN_CASE_TOL)
        cases[f'{dims}D stagger subset'] = (dims, None, lambda c, v, o, n=names: stagger(
            c, math.maximum, extrapolation.BOUNDARY, dims=[n[-1], n[0]]), OPEN_CASE_TOL)
        cases[f'{dims}D resample order 4'] = (dims, None, lambda c, v, o: resample(
            c, to=StaggeredGrid(0., 0., c.bounds, c.resolution), order=4), OPEN_CASE_TOL)
        cases[f'{dims}D semi_lagrangian gather'] = (dims, None, lambda c, v, o: advect.semi_lagrangian(
            c, o, 1.0, max_cells=None), OPEN_STEP_TOL)
        cases[f'{dims}D semi_lagrangian rk4'] = (dims, None, lambda c, v, o: advect.semi_lagrangian(
            c, o, 1.0, integrator=advect.rk4), OPEN_STEP_TOL)
        cases[f'{dims}D mac_cormack open box'] = (dims, None, lambda c, v, o: advect.mac_cormack(o, o, 1.0),
                                                  OPEN_STEP_TOL)
        cases[f'{dims}D points in the open box'] = (dims, None, lambda c, v, o, n=N: o.sample(Point(math.wrap(
            torch.linspace(-1., n + 1., 4096, device=o.values.device)[:, None].expand(-1, len(o.resolution.names))
            .contiguous() * torch.tensor([1.0, 0.37, 0.71][:len(o.resolution.names)], device=o.values.device),
            math.instance('p'), math.channel(vector=o.resolution.names)))), OPEN_CASE_TOL)
    for name, (dims, rule, fn, tol) in cases.items():
        card, cpu = [_case_on(dev, fn, dims, rule) for dev in ('cuda', 'cpu')]
        errs = [_scale_err(a, b) for a, b in zip(card, cpu)]
        shapes = len(card) == len(cpu) and all(a.shape == b.shape for a, b in zip(card, cpu))
        ok = shapes and max(errs) <= tol
        print(f'10d {name}: card vs CPU scaled error {max(errs):.2e} (tol {tol:.0e}), shapes '
              f'{[tuple(a.shape) for a in card]}: {"ok" if ok else "FAIL"}')
        if not ok:
            raise RuntimeError(f'10d {name}: {errs}, shapes equal {shapes}')
    by_path = {}
    for dims in (3, 2):
        c, closed, _ = _open_case_fields(dims, 'cuda')
        fast = closed * (2.9 / float(advect.max_displacement_cells(c, closed, 1.0)))  # a CFL of 2.9
        with math.default_device('cuda'):
            torch.cuda.synchronize()
            _build.reset_launches()
            syncs, lines, _ = syncs_a_step(lambda st: advect.semi_lagrangian(st, fast, 1.0, max_cells=1,
                                                                             substeps='auto'), c)
            launches = dict(_build.LAUNCHES)
            m = float(advect.max_displacement_cells(c, fast, 1.0))
            auto = advect.semi_lagrangian(c, fast, 1.0, max_cells=1, substeps='auto')
        n = min(max(int(-(-m // 1)), 1), 4)
        row = f'window_interp_{dims}d'
        cpu_c, cpu_closed, _ = _open_case_fields(dims, 'cpu')
        with math.default_device('cpu'):
            cpu_fast = cpu_closed * (2.9 / float(advect.max_displacement_cells(cpu_c, cpu_closed, 1.0)))
            ref = advect.semi_lagrangian(cpu_c, cpu_fast, 1.0, max_cells=1, substeps='auto')
        err = _scale_err(auto.values.torch(auto.values.shape.names), ref.values.torch(ref.values.shape.names))
        ok = launches.get(row, 0) == n and syncs <= 2 and err <= OPEN_STEP_TOL
        print(f'10d {dims}D substeps=auto, max |disp| {m:.3f} cells (max_cells 1): {n} substeps, {row} launched '
              f'{launches.get(row, 0)}, {syncs} device syncs a call ({", ".join(lines)}); card vs CPU {err:.2e} '
              f'(tol {OPEN_STEP_TOL:.0e}): {"ok" if ok else "FAIL"}')
        if not ok:
            raise RuntimeError(f'10d auto substeps {dims}D: launches {launches}, syncs {syncs}, error {err}')
        by_path[f'open-auto-{dims}d'] = launches
    by_path['open-grad-2d'] = run_open_gradient()
    return by_path


def run_open_gradient():
    """10d: `math.gradient` of one step of an open-box 2D flow (the inflow channel of `_open_case_fields`: the
    smoke's MacCormack, the velocity's semi-Lagrangian self-advection, `make_incompressible` at 1e-5) of
    L = Σ w·s + Σ w·v_x (w the smooth weight of phase 6, `_smooth_weight`) with respect to the initial
    velocity and smoke, on the card: K7ᵀ once for each forward K7 launch, finite gradients, and the card's
    gradient within 1e-4 of its scale of the CPU's (with L = Σ v_x² instead, whose adjoint right-hand side
    is the whole inflow, the devices' float32 solves left 7.3e-4 at 1e-6 and 8.4e-4 at 1e-5 between them,
    the advection's parts 4e-7; with w, 5.3e-6)."""
    import torch
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.math import ConvergenceException, Solve
    from phiflow_tpu_torch.ops import _build
    from phiflow_tpu_torch.physics import advect, fluid
    N = OPEN_CASES_N[2]

    def grads(device, record=None):
        c, _, v = _open_case_fields(2, device)
        w = _smooth_weight(N, 2).to(device).double()

        def loss(v, s):
            s = advect.mac_cormack(s, v, 1.0)
            v = advect.semi_lagrangian(v, v, 1.0)
            v, _ = fluid.make_incompressible(v, (), Solve('CG', 1e-5, 1e-5, max_iterations=300,
                                                          suppress=(ConvergenceException,)))
            out = (s.values.torch(('x', 'y')).double() * w).sum() + \
                (v.vector['x'].values.torch(('x', 'y')).double() * w).sum()
            if record is not None:
                torch.cuda.synchronize()
                record['forward'] = dict(_build.LAUNCHES)
                _build.reset_launches()
            return out
        _build.reset_launches()
        with math.default_device(device):
            _, gv, gs = math.gradient(loss, wrt=[0, 1])(v, c)
        return [a.detach() for a in _staggered_arrays(gv)] + [gs.values.torch(('x', 'y')).detach()]
    record = {}
    card = grads('cuda', record)
    torch.cuda.synchronize()
    backward = dict(_build.LAUNCHES)
    cpu = grads('cpu')
    errs = [_scale_err(a, b) for a, b in zip(card, cpu)]
    finite = all(bool(torch.isfinite(a).all()) for a in card)
    k7 = record['forward'].get('window_interp_2d', 0)
    ok = k7 > 0 and backward.get('window_interp_2d_grad', 0) == k7 and finite and max(errs) <= OPEN_CASE_TOL
    print(f'10d open-grad-2d {N}^2, 1 step: math.gradient of the loss; launches forward window_interp_2d={k7}, '
          f'backward window_interp_2d_grad={backward.get("window_interp_2d_grad", 0)}; card vs CPU scaled errors '
          + ', '.join(f'{e:.2e}' for e in errs) + f' (tol {OPEN_CASE_TOL:.0e}); finite {finite}: '
          f'{"ok" if ok else "FAIL"}')
    if not ok:
        raise RuntimeError(f'open-grad-2d: forward {record["forward"]}, backward {backward}, errors {errs}')
    return {k: record['forward'].get(k, 0) + backward.get(k, 0) for k in KERNELS}


def run_open_boundaries(ch):
    """Phase 10: open and mixed boundaries (10a–10d)."""
    import torch
    part = PhaseClock('part of phase')
    by_path = {}
    model, fields, inflow, solve = open_plume()
    by_path[f'open-plume-{OPEN_N}'] = run_open_path(ch, f'open-plume-{OPEN_N}', model, fields, inflow, solve,
                                                    f'{OPEN_N}^3', OPEN_N ** 3)
    del model, fields, inflow
    torch.cuda.empty_cache()
    part.done(f'10a open-plume-{OPEN_N}')
    size = 'x'.join(str(n) for n in TUNNEL_RES)
    model, fields, inflow, solve = open_tunnel()
    by_path[f'tunnel-step-{size}'] = run_open_path(ch, f'tunnel-step-{size}', model, fields, inflow, solve, size,
                                                   TUNNEL_RES[0] * TUNNEL_RES[1] * TUNNEL_RES[2])
    del model, fields, inflow
    torch.cuda.empty_cache()
    part.done(f'10b tunnel-step-{size}')
    open_cpu_vs_card('open-plume-48', lambda dev: open_plume(48, dev))
    open_cpu_vs_card('tunnel-step-64x32x32', lambda dev: open_tunnel(dev, (64, 32, 32)))
    part.done('10a-10b CPU against card')
    by_path.update(run_open_recipes(ch))
    part.done('10c the 2D recipes')
    by_path.update(run_open_cases(ch))
    torch.cuda.empty_cache()
    part.done('10d the Field cases')
    return by_path


# ---------------------------------------------------------------------------
# phase 11: the 3D mesh slice (mesh-channel-3d), I/O and utilities, the Field cases that raised, entry()
# ---------------------------------------------------------------------------

# mesh-channel-3d: unit hexahedra over [0, 96] × [0, 32] × [0, 32] without the cube x ∈ [16, 24), y, z ∈ [12, 20):
# 96·32·32 − 512 = 97,792 cells; CylinderWake's step in 3D at Re 150 on the cube's side (ν = 8 / 150), dt 0.5
CHANNEL = dict(nx=96, ny=32, nz=32, cube=((16, 24), (12, 20), (12, 20)))
CHANNEL_SMALL = dict(nx=12, ny=6, nz=6, cube=((2, 4), (2, 4), (2, 4)))  # CPU against card
CHANNEL_STEP = dict(dt=0.5, viscosity=8 / 150, tol=1e-4, max_iterations=500)
CHANNEL_RUNS = (1, 2)  # warm-up, timed steps
CHANNEL_CPU_TOL = 1e-4  # of each field's scale, with equal BiCGStab counts
# `projection_readings`' gates: the pressure solve's residual in L2, 10× its tol 1e-4 (BiCGStab's recurrence residual
# drifts from the true one), and the subtraction of G p (float32 rounding of O(1) values; 2.7e-07 at 12 × 6 × 6)
CHANNEL_RESIDUAL_TOL = 1e-3
CHANNEL_GRADIENT_TOL = 1e-4
IO_N = 256     # the smoke state written, read, put in a scene and a checkpoint
CASES_N = 64   # the Field cases card against CPU
CASES_POINTS = 64


def channel_arrays(nx, ny, nz, cube):
    """(points, hexes, groups) of the channel: unit hexahedra over [0, nx] ×
    [0, ny] × [0, nz] without the cells of `cube` ((lo, hi) cells an axis),
    SU2 / VTK vertex order; the groups inlet (x = 0), outlet (x = nx), walls
    (y, z on the box) and cube, each an (n, 4) array of the hexes' boundary
    quads."""
    import numpy as np
    vid = np.arange((nx + 1) * (ny + 1) * (nz + 1)).reshape(nx + 1, ny + 1, nz + 1)
    pts = np.stack(np.meshgrid(np.arange(nx + 1), np.arange(ny + 1), np.arange(nz + 1), indexing='ij'), -1)
    pts = pts.reshape(-1, 3).astype(np.float32)
    keep = np.ones((nx, ny, nz), bool)
    keep[tuple(slice(lo, hi) for lo, hi in cube)] = False
    i, j, k = np.nonzero(keep)
    hexes = np.stack([vid[i, j, k], vid[i + 1, j, k], vid[i + 1, j + 1, k], vid[i, j + 1, k],
                      vid[i, j, k + 1], vid[i + 1, j, k + 1], vid[i + 1, j + 1, k + 1], vid[i, j + 1, k + 1]], 1)
    padded = np.zeros((nx + 2, ny + 2, nz + 2), bool)
    padded[1:-1, 1:-1, 1:-1] = keep
    groups = {'inlet': [], 'outlet': [], 'walls': [], 'cube': []}
    # a hexahedron's faces (the mesh's own order) and the neighbour each faces: z-, z+, y-, x+, y+, x-
    for tpl, (dx, dy, dz) in (((0, 3, 2, 1), (0, 0, -1)), ((4, 5, 6, 7), (0, 0, 1)), ((0, 1, 5, 4), (0, -1, 0)),
                              ((1, 2, 6, 5), (1, 0, 0)), ((2, 3, 7, 6), (0, 1, 0)), ((3, 0, 4, 7), (-1, 0, 0))):
        faces = hexes[~padded[i + 1 + dx, j + 1 + dy, k + 1 + dz]][:, list(tpl)]
        c = pts[faces].mean(1)
        inlet, outlet = c[:, 0] == 0, c[:, 0] == nx
        walls = ~inlet & ~outlet & ((c[:, 1] == 0) | (c[:, 1] == ny) | (c[:, 2] == 0) | (c[:, 2] == nz))
        for name, sel in (('inlet', inlet), ('outlet', outlet), ('walls', walls), ('cube', ~(inlet | outlet | walls))):
            groups[name].append(faces[sel])
    return pts, hexes, {name: np.concatenate(f) for name, f in groups.items()}


def write_su2(path, pts, hexes, groups):
    """The channel as an SU2 ASCII file: hexahedra (VTK 12), points, one quad (VTK 9) marker a group."""
    with open(path, 'w') as f:
        f.write(f'NDIME= 3\nNELEM= {len(hexes)}\n')
        f.writelines(f'12 {" ".join(map(str, h))} {e}\n' for e, h in enumerate(hexes.tolist()))
        f.write(f'NPOIN= {len(pts)}\n')
        f.writelines(f'{x:g} {y:g} {z:g} {n}\n' for n, (x, y, z) in enumerate(pts.tolist()))
        f.write(f'NMARK= {len(groups)}\n')
        for name, faces in groups.items():
            f.write(f'MARKER_TAG= {name}\nMARKER_ELEMS= {len(faces)}\n')
            f.writelines(f'9 {" ".join(map(str, q))}\n' for q in faces.tolist())


def channel_state(mesh, cube):
    """The uniform stream (1, 0, 0) with CylinderWake's transverse kick upstream of the cube, and p = 0."""
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.field import Field
    from phiflow_tpu_torch.physics import fluid
    one = math.vec(x=1., y=0., z=0.)
    bc = {'inlet': one, 'outlet': math.extrapolation.ZERO_GRADIENT, 'walls': one, 'cube': 0.}
    cx = mesh.center[{'vector': 'x'}]
    kick = 0.05 * math.exp(-(cx - (cube[0][0] + cube[0][1]) / 2) ** 2)
    v = Field(mesh, math.stack({'x': math.ones_like(cx), 'y': kick, 'z': math.zeros_like(cx)},
                               math.channel(vector='x,y,z')), bc)
    return v, Field(mesh, math.zeros_like(cx), fluid._pressure_extrapolation(v.boundary))


def channel_step(v, p, dt, viscosity, tol, max_iterations):
    """CylinderWake's step (`models/cylinder_wake.py`) on the channel: implicit
    momentum by BiCGStab on `_momentum_eq`, then `make_incompressible` with
    'auto' (BiCGStab, the mesh Chebyshev preconditioner). Returns v, p, max |div|
    before and after the projection (device scalars), the solves' iterations and
    the projection's Fields for `projection_readings` (the divergences before and
    after it, the velocity's boundary)."""
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.field import divergence
    from phiflow_tpu_torch.models.cylinder_wake import _momentum_eq
    from phiflow_tpu_torch.physics import fluid
    with math.SolveTape() as tape:
        mom = math.Solve('biCG-stab', tol, tol, x0=v, max_iterations=max_iterations,
                         suppress=(math.ConvergenceException,))
        v = math.solve_linear(_momentum_eq, v, mom, v, dt, viscosity, False)
        div = divergence(v)
        before = div.values.native(('cells',)).abs().max()
        prs = math.Solve('auto', tol, tol, x0=p, max_iterations=max_iterations, suppress=(math.ConvergenceException,))
        boundary = v.boundary
        v, p = fluid.make_incompressible(v, (), prs)
    div_after = divergence(v)
    after = div_after.values.native(('cells',)).abs().max()
    return v, p, before, after, [info.iterations for info in tape], (div, div_after, boundary)


def projection_readings(p, fields):
    """What a projection of the channel left, from its pressure `p` and `channel_step`'s Fields: (a) the pressure
    solve's residual, |L p − div| over |div| in L2 (L the compact mesh Laplacian that `make_incompressible` solves,
    `masked_laplace`); (b) max |div after − (div − D G p)| over max |div| (G the Green-Gauss gradient it subtracts, D
    the divergence under the velocity boundary's linear part): whether the step subtracted G p; (c) max |div after −
    (L p − D G p)| over max |div|. The collocated scheme leaves L p − D G p in the divergence: D G p is the wide
    Laplacian (a cell's neighbours' neighbours), which the compact L solved does not cancel, so a converged
    projection reduces |div| by about half on this mesh (the JAX package's too). (a) and (b) small say the solve
    converged and its gradient was subtracted; (c) says the rest of |div| is that mismatch and nothing else.
    Returns (a, b, c, max |L p − D G p|) as floats."""
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.field import divergence, spatial_gradient
    from phiflow_tpu_torch.physics import fluid
    div, div_after, boundary = fields
    lap = fluid.masked_laplace(p, boundary, None, None, wide_stencil=False, order=2)
    grad = spatial_gradient(p, boundary, at='center', order=2)
    wide = divergence(grad.with_boundary(math.extrapolation.remove_constant_offset(boundary)))
    b, a, L, W = (f.values.native(('cells',)).double() for f in (div, div_after, lap, wide))
    scale = float(b.abs().max())
    return (float((L - b).norm() / b.norm()), float((a - (b - W)).abs().max()) / scale,
            float((a - (L - W)).abs().max()) / scale, float((L - W).abs().max()))


def run_mesh_channel(tag='mesh-channel-3d', warmup=CHANNEL_RUNS[0], steps=CHANNEL_RUNS[1]):
    """mesh-channel-3d on the card: the mesh's build on the host (`geom.mesh` of the arrays, the tables' copy to the
    card included), written as SU2 and read back by `load_su2` (its tables equal the built ones), then CylinderWake's
    step in 3D: ms a step on the host clock, BiCGStab iterations a solve, syncs of the warm-up step,
    max_memory_allocated, device busy ms and kernels a step (torch.profiler, one more step). Gates: 97,792 cells,
    finite velocity and pressure, |div| after each projection below its value before, each projection's pressure
    residual and subtracted gradient (`projection_readings`), no kernel of ours launched.
    Returns the launch counts of the timed steps."""
    import os
    import tempfile
    import numpy as np
    import torch
    from phiflow_tpu_torch import geom
    from phiflow_tpu_torch.ops import _build
    t0 = time.perf_counter()
    pts, hexes, groups = channel_arrays(**CHANNEL)
    mesh = geom.mesh(pts, hexes, groups)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'channel.su2')
        t0 = time.perf_counter()
        write_su2(path, pts, hexes, groups)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = geom.load_su2(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    unequal = [name for name in FVM_TABLES if not torch.equal(_mesh_table(loaded, name), _mesh_table(mesh, name))]
    if unequal or loaded.boundaries != mesh.boundaries:
        raise RuntimeError(f'{tag}: load_su2 tables differ from mesh(...) of the same arrays: {unequal}, '
                           f'{loaded.boundaries} / {mesh.boundaries}')
    cells = loaded.cell_count
    expected = CHANNEL['nx'] * CHANNEL['ny'] * CHANNEL['nz'] - int(np.prod([hi - lo for lo, hi in CHANNEL['cube']]))
    if cells != expected:
        raise RuntimeError(f'{tag}: {cells} cells, {expected} expected')
    v, p = channel_state(loaded, CHANNEL['cube'])
    divs, kept = [], []
    for k in range(warmup):
        syncs, sync_lines, (v, p, before, after, warm_its, fields) = syncs_a_step(
            lambda state: channel_step(*state, **CHANNEL_STEP), (v, p))
        divs.append((float(before), float(after)))
        kept.append((p, fields))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    its = []
    t0 = time.perf_counter()
    for _ in range(steps):
        v, p, before, after, step_its, fields = channel_step(v, p, **CHANNEL_STEP)
        its.append(step_its)
        divs.append((before, after))
        kept.append((p, fields))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    launches = {k: n for k, n in _build.LAUNCHES.items() if n}
    peak = torch.cuda.max_memory_allocated()
    divs = [(float(b), float(a)) for b, a in divs]
    readings = [projection_readings(*k) for k in kept]
    del kept
    vel, pres = v.values.native(('cells', 'vector')), p.values.native(('cells',))
    finite = bool(torch.isfinite(vel).all()) and bool(torch.isfinite(pres).all())
    device_ms, wall_ms = profile_path(tag, f'{cells} cells', lambda state: channel_step(*state, **CHANNEL_STEP)[:2],
                                      (v, p), warmup=0, steps=1)
    print(f'{tag} {cells} cells ({len(hexes)} hexahedra, {", ".join(f"{k} {len(f)}" for k, f in groups.items())} '
          f'boundary quads): mesh built on the host in {build_s:.2f} s (tables to the card included), SU2 written in '
          f'{write_s:.2f} s and loaded in {load_s:.2f} s (tables equal); {ms:.2f} ms/step over {steps} step(s) after '
          f'{warmup} warm-up, {cells / ms * 1e-3:.4f} Mcells/s; BiCGStab iterations (momentum, pressure) a step '
          f'{its} (warm-up {warm_its}); syncs in the warm-up step {syncs} {sync_lines or ""}; max_memory_allocated '
          f'{peak / 2 ** 30:.3f} GiB; device busy {device_ms:.2f} ms/step under the profiler ({wall_ms:.2f} ms wall); '
          f'max |div| before / after each projection {", ".join(f"{b:.3e} / {a:.3e}" for b, a in divs)}; max |v| '
          f'{float(vel.abs().max()):.4f}, max |p| {float(pres.abs().max()):.4f}; kernels of ours launched: '
          f'{launches or "none"}; all finite: {finite}')
    print(f'{tag} each projection (`projection_readings`): pressure residual |L p - div| / |div| (L2; tol '
          f'{CHANNEL_RESIDUAL_TOL:g}), max |div after - (div - D G p)| / max |div| (tol {CHANNEL_GRADIENT_TOL:g}), '
          f'max |div after - (L p - D G p)| / max |div| (tol {CHANNEL_RESIDUAL_TOL:g}), max |L p - D G p|: '
          + ', '.join(f'{r:.3e} / {g:.3e} / {m:.3e} / {w:.3e}' for r, g, m, w in readings))
    bad = []
    if launches:
        bad.append(f'kernels of ours launched {launches}')
    if not finite:
        bad.append('velocity or pressure not finite')
    if not all(a < b for b, a in divs):
        bad.append(f'|div| not reduced by a projection: {divs}')
    if not all(r <= CHANNEL_RESIDUAL_TOL and g <= CHANNEL_GRADIENT_TOL and m <= CHANNEL_RESIDUAL_TOL
               for r, g, m, _ in readings):
        bad.append(f'a projection did not solve L p = div or subtract G p: {readings}')
    if bad:
        raise RuntimeError(f'{tag}: ' + '; '.join(bad))
    return dict(steps=steps)


def _mesh_table(mesh, name):
    order = {'center': ('cells', 'vector'), 'volume': ('cells',), 'vertices': ('vertices', 'vector'),
             'face_centers': ('cells', '~faces', 'vector'), 'face_normals': ('cells', '~faces', 'vector')}
    return getattr(mesh, name).native(order.get(name, ('cells', '~faces')))


def channel_cpu_vs_card(steps=2, tol=CHANNEL_CPU_TOL):
    """The mesh-channel-3d recipe at 12 × 6 × 6 with a 2³ cube on the CPU and the card: velocity and pressure within
    `tol` of scale each step, equal BiCGStab counts."""
    import numpy as np
    from phiflow_tpu_torch import geom, math
    out = {}
    for dev in ('cpu', 'cuda'):
        with math.default_device(dev):
            mesh = geom.mesh_from_numpy(*channel_arrays(**CHANNEL_SMALL))
            v, p = channel_state(mesh, CHANNEL_SMALL['cube'])
            rows = []
            for _ in range(steps):
                v, p, _, _, its, _ = channel_step(v, p, **CHANNEL_STEP)
                rows.append((v.values.native(('cells', 'vector')).cpu().numpy(),
                             p.values.native(('cells',)).cpu().numpy(), its))
            out[dev] = rows
    for k, ((vc, pc, ic), (vg, pg, ig)) in enumerate(zip(out['cpu'], out['cuda'])):
        ev = float(np.abs(vc - vg).max()) / float(np.abs(vc).max())
        ep = float(np.abs(pc - pg).max()) / max(float(np.abs(pc).max()), 1e-30)
        ok = ev <= tol and ep <= tol and ic == ig
        print(f'cpu vs card, mesh-channel-3d at 12x6x6 step {k + 1}: velocity {ev:.2e}, pressure {ep:.2e} of scale '
              f'(tol {tol:g}); BiCGStab iterations cpu {ic}, card {ig} {"ok" if ok else "FAIL"}')
        if not ok:
            raise RuntimeError(f'mesh-channel-3d: CPU and card disagree at step {k + 1}: {ev}, {ep}, {ic} / {ig}')


def run_io_round_trips(N=IO_N):
    """A 256³ smoke state (staggered velocity, smoke, pressure) from the card: `field.write` / `field.read`, a
    `Scene` (write, read, properties, frames) and a checkpoint restored onto the card, each back on the card and
    bit-equal; seconds of each."""
    import os
    import tempfile
    import torch
    from phiflow_tpu_torch import field, utils
    from phiflow_tpu_torch.models import SmokePlume, state_from_numpy
    *vel, smoke, _ = smooth_state(N, 3)
    model = SmokePlume(resolution=N, dims=3, device='cuda')
    state = model.state_fields(*state_from_numpy(*vel, smoke, smoke * 0.3 - 0.1, device='cuda'))
    names = ('velocity', 'smoke', 'pressure')
    mb = sum(t.numel() * 4 for f in state for t in _field_tensors(f)) / 2 ** 20

    def same(got):
        return all(a.is_cuda and torch.equal(a, b) for g, f in zip(got, state)
                   for a, b in zip(_field_tensors(g), _field_tensors(f)))
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        for name, f in zip(names, state):
            field.write(f, os.path.join(tmp, name))
        seconds['write'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = [field.read(os.path.join(tmp, name)) for name in names]
        torch.cuda.synchronize()
        seconds['read'] = time.perf_counter() - t0
        ok = {'write / read': same(back) and all(b.boundary == f.boundary for b, f in zip(back, state))}
        t0 = time.perf_counter()
        scene = field.Scene.create(os.path.join(tmp, 'scenes'), copy_calling_script=True, N=N)
        scene.write(dict(zip(names, state)), frame=3)
        back = scene.read(*names, frame=3)
        torch.cuda.synchronize()
        seconds['scene'] = time.perf_counter() - t0
        ok['scene'] = same(back) and scene.frames == (3,) and scene.properties == {'N': N} and \
            os.path.isfile(os.path.join(scene.path, 'src', os.path.basename(__file__)))
        t0 = time.perf_counter()
        path = utils.save_checkpoint(os.path.join(tmp, 'ckpt'), state)
        back = utils.load_checkpoint(path, device='cuda')
        torch.cuda.synchronize()
        seconds['checkpoint'] = time.perf_counter() - t0
        ok['checkpoint'] = same(back)
    print(f'io {N}^3 smoke state ({mb:.0f} MiB on the card): ' + ', '.join(f'{k} {v:.2f} s' for k, v in seconds.items())
          + '; back on the card bit-equal: ' + ', '.join(f'{k} {v}' for k, v in ok.items()))
    if not all(ok.values()):
        raise RuntimeError(f'io round trips not bit-equal: {ok}')


def _field_tensors(f):
    """A grid Field's torch tensors, the axes in x, y, z order: its face components x, y, z, or its values (a read
    Field may hold its dims in another order)."""
    names = tuple(sorted(f.resolution.names))
    if f.is_staggered:
        return [f.vector[d].values.native(names) for d in names]
    return [f.values.native(names)]


def field_cases_cpu_vs_card(N=CASES_N, points=CASES_POINTS, tol=1e-5):
    """The Field cases that raised before, on the card against the CPU at 64³ from the same numpy inputs: the
    divergence of a staggered velocity under ANTISYMMETRIC walls, a cloud of spheres resampled onto a centred grid
    without scatter (hard and soft) and onto a staggered one, and a grid Field and the cloud sampled at the
    mesh-channel-3d recipe's 12 × 6 × 6 mesh. Each result a torch tensor on the card, within `tol` of scale of
    the CPU's."""
    import numpy as np
    from phiflow_tpu_torch import field, geom, math
    from phiflow_tpu_torch.models import to_device
    rng = np.random.default_rng(23)
    res = dict(x=N, y=N, z=N)
    values = rng.standard_normal((N, N, N, 3)).astype(np.float32)
    centres = rng.uniform(0, N, (points, 3)).astype(np.float32)
    out = {}
    for dev in ('cpu', 'cuda'):
        with math.default_device(dev):
            vel = to_device(field.CenteredGrid(math.tensor(values, math.spatial('x,y,z'), math.channel(vector='x,y,z')),
                                               0., **res), dev)
            pts = math.tensor(centres, math.instance('points'), math.channel(vector='x,y,z'))
            cloud = to_device(field.PointCloud(geom.Sphere(pts, radius=2.5), pts * 0.1), dev)
            mesh = geom.mesh_from_numpy(*channel_arrays(**CHANNEL_SMALL))
            target = field.CenteredGrid(0, 0, **res)
            results = {
                'divergence, ANTISYMMETRIC walls':
                    field.divergence(field.StaggeredGrid(vel, math.extrapolation.ANTISYMMETRIC, **res)).values,
                'points onto a centred grid, hard': field.resample(cloud, target).values,
                'points onto a centred grid, soft': field.resample(cloud, target, soft=True).values,
                'points onto a staggered grid': field.resample(cloud, field.StaggeredGrid(0, 0, **res)).values,
                'a grid Field at a mesh': field.sample(vel, mesh),
                'points at a mesh': field.sample(cloud, mesh),
            }
            out[dev] = {k: _case_numpy(t, dev) for k, t in results.items()}
    for case, (ref, _) in out['cpu'].items():
        got, on_card = out['cuda'][case]
        err = max(float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30) for a, b in zip(got, ref))
        ok = on_card and err <= tol
        print(f'cpu vs card, Field case at {N}^3: {case}: {err:.2e} of scale (tol {tol:g}), on the card: {on_card} '
              f'{"ok" if ok else "FAIL"}')
        if not ok:
            raise RuntimeError(f'Field case {case!r}: card against CPU {err}, on the card {on_card}')


def _case_numpy(t, dev):
    """(arrays of a result's components, whether each native lies on `dev`)."""
    import torch
    parts = [t[{'~vector': l}] for l in t.shape.get_labels('~vector')] if '~vector' in t.shape.names else [t]
    natives = [p.native(tuple(sorted(p.shape.names))) for p in parts]
    on = all(isinstance(n, torch.Tensor) and n.device.type == torch.device(dev).type for n in natives)
    return [n.detach().cpu().numpy() if isinstance(n, torch.Tensor) else n for n in natives], on


def run_entry(steps=2):
    """`phiflow_tpu_torch._entry.entry()` on the card: its SmokePlume 16³ step twice, finite, with K6 and the
    projection's kernels launched."""
    import torch
    from phiflow_tpu_torch._entry import entry
    from phiflow_tpu_torch.ops import _build
    fn, state = entry()
    _build.reset_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        state = fn(*state)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    launches = {k: n for k, n in _build.LAUNCHES.items() if n}
    finite = all(bool(torch.isfinite(t).all()) for f in state for t in _field_tensors(f))
    smoke = float(_field_tensors(state[1])[0].max())
    print(f'entry(): SmokePlume(16, dims=3) {ms:.2f} ms/step over {steps} steps (the first included), max smoke '
          f'{smoke:.4f}, all finite: {finite}; kernels of ours launched: {launches}')
    if not finite or smoke <= 0 or not launches.get('window_interp_3d') or not launches.get('poisson_stencil'):
        raise RuntimeError(f'entry(): finite={finite}, max smoke {smoke}, launches {launches}')
    return launches


def run_mesh_and_io():
    """Phase 11: mesh-channel-3d, its CPU against the card, the I/O round trips, the Field cases, entry()."""
    import torch
    part = PhaseClock('part of phase')
    by_path = {'mesh-channel-3d': run_mesh_channel()}
    torch.cuda.empty_cache()
    channel_cpu_vs_card()
    part.done('11 mesh-channel-3d and its CPU against card')
    run_io_round_trips()
    torch.cuda.empty_cache()
    part.done('11 I/O round trips')
    field_cases_cpu_vs_card()
    torch.cuda.empty_cache()
    part.done('11 Field cases')
    by_path['entry'] = run_entry()
    part.done('11 entry()')
    return by_path


# ---------------------------------------------------------------------------
# phase 12: the splines (spline-flip-128, the spline shapes and obstacle on the card, transform_with_spline) and
# the user namespace
# ---------------------------------------------------------------------------

SPLINE_N = 128  # spline-flip-128: FLIP's full width, a SplineSolid chute in place of terrain-flip's heightmap
SPLINE_FILLET = {'u-': 1, 'u+': 1, 'v-': .5, 'v+': .5}
SPLINE_ORDER = {'u': 2, 'v': 1}
# the chute's translation in the CPU-against-card witnesses, in cells: scaled to 32³ (and 16³) the net's v edges
# put whole planes of cell and face centres exactly on the fillet's surface or edge, where the inside test and the
# fillet branch are rounding ties on any device; a generic sub-cell shift leaves none
SPLINE_WITNESS_SHIFT = (0.137, 0.291, 0.073)
# float32 card against CPU: of the entries where the CPU's float32 lies within 1e-4 of the scale of its float64
# (well-conditioned), the largest share that may part by more than 1e-4 of the scale (`hold_float32`); twice the
# H100's readings: 0.097% of the 32³ push, 0.298% / 0.245% of the 32³ / 16³ masks, 0.484% / 0.376% of the chute's /
# transform_with_spline's 10⁶ points
FLOAT32_APART = {'push': 0.002, 'masks': 0.006, 'points': 0.01}


def chute_net(n, lip=0., shift=(0., 0., 0.)):
    """The chute's 5 × 3 control net at n³ (the 128³ net scaled by n / 128): u along x at x = 16, 40, 64, 88, 112,
    v along y at y = 24, 64, 104, z = 64, 44, 28, 24, 34 (+ `lip` at the last row) along u; moved by `shift`
    cells."""
    import numpy as np
    s = n / 128
    xs, ys = np.array([16, 40, 64, 88, 112.]) * s, np.array([24, 64, 104.]) * s
    zs = np.array([64, 44, 28, 24, 34. + lip]) * s
    net = np.stack(np.broadcast_arrays(xs[:, None], ys[None, :], zs[:, None]), -1) + np.asarray(shift)
    return net.astype(np.float32)


def spline_chute(n, device, thickness=8., lip=0., bits=32, shift=(0., 0., 0.)):
    """SplineSolid(points, thickness, fillet={'u-': 1, 'u+': 1, 'v-': .5, 'v+': .5}, order={'u': 2, 'v': 1}) at
    n³ (thickness scaled by n / 128), its float32 control points on `device`; with `bits=64` its float64 witness
    (`as_float64`)."""
    import torch
    from phiflow_tpu_torch import geom, math
    points = math.wrap(torch.as_tensor(chute_net(n, lip, shift), device=device), math.spatial('u,v'),
                       math.channel(vector='x,y,z'))
    chute = geom.SplineSolid(points, thickness=thickness * n / 128, fillet=SPLINE_FILLET, order=SPLINE_ORDER)
    return as_float64(chute) if bits == 64 else chute


def as_float64(solid):
    """The float64 witness of a SplineSolid: its control points cast to float64 and every query computed in
    float64 (`_float64_spline_class`), its results handed back in the precision of the points asked."""
    import torch
    from phiflow_tpu_torch import math
    return _float64_spline_class()(math.cast(solid.points, torch.float64), solid.thickness, solid.fillet, solid.order)


@functools.lru_cache(maxsize=None)
def _float64_spline_class():
    """A SplineSolid whose closest surface (and so its inside test, signed distance and push) is computed in
    float64 at points of any precision, the distance, delta and normal cast back to the points' dtype. The
    points are flattened to one list first, so that the CPU and the card sum each point's squared distances to
    the control points in the same layout: a seed tie (a point equidistant from two control points, common at
    cell centres) then breaks the same way on both."""
    import torch
    from phiflow_tpu_torch import geom, math

    class Float64SplineSolid(geom.SplineSolid):
        def approximate_closest_surface(self, location):
            dtype, dims = location.dtype, location.shape.without('vector')
            flat = math.pack_dims(location, dims, math.instance('_q')) if dims else location
            with math.precision(64):
                out = super().approximate_closest_surface(math.cast(flat, torch.float64))
            out = [math.cast(o, dtype) for o in out[:3]] + list(out[3:])
            return tuple(math.unpack_dim(o, '_q', dims) if o is not None and dims else o for o in out)

    return Float64SplineSolid


def spline_setup(N, device, shift=(0., 0., 0.)):
    """spline-flip's state at N³ unit cells in a closed box: the chute (moved by `shift` cells) and the liquid
    block Box['x,y,z', 16:64, 16:112, 80:116] at 128³ (scaled by N / 128), 8 particles a cell at rest (1,327,104
    at 128³). Returns (domain, chute, particles)."""
    from phiflow_tpu_torch import field, geom, math
    s = N / 128
    with math.default_device(device):
        domain = geom.Box(x=N, y=N, z=N)
        block = geom.Box['x,y,z', 16 * s:64 * s, 16 * s:112 * s, 80 * s:116 * s]
        particles = field.distribute_points(block, x=N, y=N, z=N) * (0, 0, 0)
    return domain, spline_chute(N, device, shift=shift), particles


def spline_branches(solid, loc):
    """Each point's branch of the signed distance: the seed (the flat control-point index of `_argmin_2d`) and,
    per parameter, whether the Gauss-Newton parameter overran the net's lower or upper edge (the fillet branch),
    as one int64 key a point (a torch tensor on the points' device)."""
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.geom import _spline_solid
    d2 = math.sum((loc - solid.points) ** 2, 'vector')
    iu, iv = _spline_solid._argmin_2d(d2, 'u', 'v')
    names = loc.shape.without('vector').names
    seed = iu.native(names).long() * solid.points.shape.get_size('v') + iv.native(names).long()
    _, uv, unbounded, _ = _spline_solid.closest_param(solid.order, solid.points, loc)
    uv, unbounded = uv.native(names + ('vector',)), unbounded.native(names + ('vector',))
    over = (unbounded < uv - 1e-6).long() + 2 * (unbounded > uv + 1e-6).long()
    return seed * 16 + over[..., 0] * 4 + over[..., 1]


def _spline_gaps(points, N):
    """The chute's signed distance at an (n, 3) torch tensor of points, in cells."""
    from phiflow_tpu_torch import math
    loc = math.tensor(points, math.instance('p'), math.channel(vector='x,y,z'))
    return spline_chute(N, points.device).approximate_signed_distance(loc).native('p')


def _apart(a, b, scales):
    """Each entry's largest gap between the arrays of `a` and of `b` (entries along the first axis), in units of
    each array's scale."""
    import torch
    return torch.stack([(x.double() - y.double()).abs().reshape(len(x), -1).amax(-1) / s
                        for x, y, s in zip(a, b, scales)]).amax(0)


def hold_float32(what, card32, cpu32, cpu64, limit):
    """Float32 card against CPU where it is well-conditioned. `card32`, `cpu32`, `cpu64`: lists of arrays, entries
    along the first axis; an array's scale is its largest |value| in the CPU's float64. An entry is
    well-conditioned where the CPU's float32 lies within 1e-4 of the scale of the CPU's float64 (a float32 query
    of a SplineSolid follows rounding where a Gauss-Newton step lies at its fillet threshold); of those, at most
    a share `limit` may part between card and CPU by more than 1e-4 of the scale. Prints the shares; raises if
    the hold fails."""
    scales = [max(float(x.double().abs().max()), 1e-6) for x in cpu64]
    good = _apart(cpu32, cpu64, scales) <= 1e-4
    apart = good & (_apart(card32, cpu32, scales) > 1e-4)
    share = int(apart.sum()) / max(int(good.sum()), 1)
    ok = share <= limit and int(good.sum()) > 0
    print(f'check float32          {what}: {100 * float(good.double().mean()):.3f}% of {len(good):,} entries '
          f'well-conditioned (the CPU\'s float32 within 1e-4 of the scale of its float64), {int(apart.sum())} of them '
          f'({100 * share:.3f}%) apart on the card by more than 1e-4 of the scale (at most {100 * limit:g}%) '
          f'{"ok" if ok else "FAIL"}')
    if not ok:
        raise RuntimeError(f'{what}: float32 card and CPU differ where it is well-conditioned')


def chute_masks(chute, n, device):
    """The masks make_incompressible makes of the chute at n³ unit cells: the accessible cells and the faces' soft
    masks, flattened into one column (on the host)."""
    import torch
    from phiflow_tpu_torch.field._resample import cell_grid, geometry_mask, staggered_cells
    from phiflow_tpu_torch.geom import union
    cells = cell_grid((n, n, n), 1.0, device)
    masks = [geometry_mask(~union([chute]), cells),
             *geometry_mask(chute, staggered_cells(cells, False), soft=True, balance=1)]
    return torch.cat([m.reshape(-1).cpu() for m in masks])[:, None]


def spline_cpu_vs_card(tag, cpu_n=32, cpu_settle=10):
    """spline-flip's step on the CPU against the card (`solid_flip_cpu_vs_card`) at cpu_n³, the chute moved by
    SPLINE_WITNESS_SHIFT (scaled to 32³ its v edges put planes of cell centres exactly on the fillet's surface:
    52 centres at |d| < 1e-13 in float64, a rounding tie on any device). With the chute's float64 witness (its
    masks and push computed in float64; the rest of the step, K8 and K1m, in float32) the step is held at FLIP's
    5e-4. The chute's float32 queries are ill-conditioned at some points (where 12 Gauss-Newton steps leave a last
    step at the fillet threshold of JAX's `approximate_closest_surface`, its sign picks the branch), and a mask
    entry that parts moves the whole projection: the float32 step's gaps are printed, and its two uses of the
    chute are held where they are well-conditioned (`hold_float32`): the push of the CPU's float32 particles
    before it, and the masks at cpu_n³ (the rest of the step is the float64 witness's float32)."""
    import torch
    from phiflow_tpu_torch import math as tmath
    shift = SPLINE_WITNESS_SHIFT
    f64, f32 = 'the chute in float64', 'the chute in float32'
    out = solid_flip_cpu_vs_card(
        tag, lambda n, dev: spline_setup(n, dev, shift), _spline_gaps,
        {f64: (lambda n, dev: spline_chute(n, dev, bits=64, shift=shift), True), f32: (None, False)}, cpu_n, cpu_settle)
    pushed, masks = {}, {}
    for dev, bits in (('cuda', 32), ('cpu', 32), ('cpu', 64)):
        with tmath.default_device(dev):
            chute = spline_chute(cpu_n, dev, bits=bits, shift=shift)
            loc = tmath.tensor(out[f32, 'cpu'][0].to(dev), tmath.instance('points'), tmath.channel(vector='x,y,z'))
            pushed[dev, bits] = [chute.push(loc, shift_amount=0.5).native(('points', 'vector')).cpu()]
            masks[dev, bits] = [chute_masks(chute, cpu_n, dev)]
    for what, res in ((f'push of the {len(pushed["cpu", 32][0]):,} particles', pushed), ('masks', masks)):
        hold_float32(f'{tag} {cpu_n}^3 chute {what}', res['cuda', 32], res['cpu', 32], res['cpu', 64],
                     FLOAT32_APART['push' if res is pushed else 'masks'])
    torch.cuda.empty_cache()


def _relative(got, ref):
    return float((got.double() - ref.double()).abs().max() / ref.double().abs().max().clamp(min=1e-6))


def check_splines_on_card(n=1_000_000, n_push=100_000):
    """The spline shapes, card against CPU, at `n` points: the chute of spline-flip-128, `to_spline(cylinder)` (a
    degenerate 2 × 2 net: its v edge 1e-5 of the depth) and `transform_with_spline` from the chute to a copy
    with its lip raised 16 cells and thickness 10. Held in float64 (`as_float64`) as the rule for a spline query
    is: at most 0.1% of the points on another branch (`spline_branches`), the signed distance (the moved points)
    at the rest within 1e-4 of its scale; at the first `n_push` points lies_inside equal but within 1e-4 of the
    surface and the push (shift 0.1 of the shape's size / 8) parting at most 0.1% by more than 1e-3 of the
    domain. Held in float32 (each shape's own float32 points) where it is well-conditioned (`hold_float32`),
    but `to_spline(cylinder)`: with its float32 points the sheet's v tangent lies below float32's rounding at
    every point (3.9% of the points within 1e-4 of float64, by chance), so its float32 signed distance is
    rounding noise on either device, held in distribution: its quantiles within 1e-2 of the scale, the inside
    shares within 0.5%. `_argmin_2d` on ties and NaN: the first index on both devices."""
    import torch
    from phiflow_tpu_torch import geom, math as tmath
    from phiflow_tpu_torch.geom import _spline_solid
    gen = torch.Generator(device='cuda')
    gen.manual_seed(12)
    cylinder = lambda: geom.to_spline(geom.cylinder(x=4, y=4, z=4, radius=2., depth=3., axis='z').rotated(
        tmath.vec(x=0.4, y=0.2, z=0.)))
    shapes = {  # name: (make(device, bits), size, float32 held point by point)
        'chute': (lambda dev, bits: spline_chute(SPLINE_N, dev, bits=bits), 128., True),
        'to_spline(cylinder)': (lambda dev, bits: as_float64(cylinder()) if bits == 64 else cylinder(), 8., False),
    }

    def run(make, pts, bits, dev, size=None):
        """(branch keys, signed distance, inside test and push at the first n_push) with `size`, else the signed
        distance alone."""
        with tmath.default_device(dev), tmath.precision(bits):
            shape = make(dev, bits)
            loc = tmath.tensor(pts.to(dev, torch.float64 if bits == 64 else torch.float32), tmath.instance('p'),
                               tmath.channel(vector='x,y,z'))
            if size is None:
                return shape.approximate_signed_distance(loc).native('p').cpu()
            few = loc[{'p': slice(0, n_push)}]
            return [spline_branches(shape, loc).cpu(), shape.approximate_signed_distance(loc).native('p').cpu(),
                    shape.lies_inside(few).native('p').cpu(),
                    shape.push(few, shift_amount=0.1 * size / 8).native(('p', 'vector')).cpu()]

    for name, (make, size, pointwise) in shapes.items():
        pts = torch.rand((n, 3), generator=gen, device='cuda', dtype=torch.float64) * size
        (gk, gd, gi, gp), (ck, cd, ci, cp) = [run(make, pts, 64, dev, size) for dev in ('cuda', 'cpu')]
        scale = float(cd.abs().max())
        branch = gk != ck
        apart = ((gd - cd).abs() > 1e-4 * scale) & ~branch
        inside_ok = bool(((gi == ci) | (cd[:n_push].abs() < 1e-4 * size)).all())
        parted = int(((gp - cp).abs().amax(-1) > 1e-3 * size).sum())
        ok = int(branch.sum()) <= 1e-3 * n and int(apart.sum()) == 0 and inside_ok and parted <= 1e-3 * n_push
        print(f'check geometry         {name:17s} at {n} points in float64: card vs CPU {int(branch.sum())} points on '
              f'another branch (at most 0.1%), {int(apart.sum())} of the rest apart by more than 1e-4 of the scale, '
              f'the rest within {_relative(gd[~branch], cd[~branch]):.2e}; at {n_push}: lies_inside equal but at the '
              f'surface {inside_ok}, the push parts {parted} by more than 1e-3 of the domain (at most 0.1%) '
              f'{"ok" if ok else "FAIL"}')
        if not ok:
            raise RuntimeError(f'geometry {name}: card and CPU differ')
        gd32, cd32 = [run(make, pts, 32, dev) for dev in ('cuda', 'cpu')]
        if pointwise:
            hold_float32(f'{name} signed distance at {n} points', [gd32], [cd32], [cd], FLOAT32_APART['points'])
            continue
        q = torch.tensor([0.05, 0.25, 0.5, 0.75, 0.95], dtype=torch.float64)
        quantiles = float((torch.quantile(gd32.double(), q) - torch.quantile(cd32.double(), q)).abs().max() / scale)
        inside = abs(float((gd32 <= 0).double().mean() - (cd32 <= 0).double().mean()))
        ok = quantiles <= 1e-2 and inside <= 5e-3 and bool(torch.isfinite(gd32).all())
        print(f'check float32          {name} signed distance at {n} points: rounding noise at every point '
              f'({100 * float(((cd32.double() - cd).abs() <= 1e-4 * scale).double().mean()):.3f}% within 1e-4 of the '
              f'scale of float64 on the CPU), held in distribution: quantiles {quantiles:.2e} of the scale apart (at '
              f'most 1e-2), inside shares {inside:.2e} apart (at most 5e-3) {"ok" if ok else "FAIL"}')
        if not ok:
            raise RuntimeError(f'geometry {name}: float32 card and CPU differ in distribution')
    pts = torch.rand((n, 3), generator=gen, device='cuda', dtype=torch.float64) * 128
    res = {}
    for bits in (64, 32):
        for dev in ('cuda', 'cpu'):
            with tmath.default_device(dev), tmath.precision(bits):
                src = spline_chute(SPLINE_N, dev, bits=bits)
                tgt = spline_chute(SPLINE_N, dev, thickness=10., lip=16., bits=bits)
                loc = tmath.tensor(pts.to(dev, torch.float64 if bits == 64 else torch.float32), tmath.instance('p'),
                                   tmath.channel(vector='x,y,z'))
                if dev == 'cuda':
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                moved = geom.transform_with_spline(loc, src, tgt).native(('p', 'vector'))
                if dev == 'cuda':
                    torch.cuda.synchronize()
                res[bits, dev] = (moved.cpu().double(), time.perf_counter() - t0)
    scale = float(res[64, 'cpu'][0].abs().max())
    apart = int(((res[64, 'cuda'][0] - res[64, 'cpu'][0]).abs().amax(-1) > 1e-4 * scale).sum())
    ok = apart <= 1e-3 * n
    print(f'check geometry         transform_with_spline at {n} points: float32 {res[32, "cuda"][1] * 1e3:.1f} ms on the '
          f'card, {res[32, "cpu"][1] * 1e3:.1f} ms on the CPU; float64 card vs CPU {apart} points apart by more than '
          f'1e-4 of the scale (at most 0.1%) {"ok" if ok else "FAIL"}')
    if not ok:
        raise RuntimeError('transform_with_spline: card and CPU differ')
    hold_float32(f'transform_with_spline at {n} points', [res[32, 'cuda'][0]], [res[32, 'cpu'][0]], [res[64, 'cpu'][0]],
                 FLOAT32_APART['points'])
    d2 = torch.tensor([[[3., 1., 2.], [1., 5., 1.]], [[float('nan'), 0., 1.], [2., float('nan'), 0.]],
                       [[4., 4., 4.], [4., 4., 4.]]])
    seeds = {}
    for dev in ('cuda', 'cpu'):
        iu, iv = _spline_solid._argmin_2d(tmath.tensor(d2.to(dev), tmath.instance('p'), tmath.spatial('u,v')), 'u', 'v')
        seeds[dev] = (iu.native('p').cpu().tolist(), iv.native('p').cpu().tolist())
    print(f'check geometry         _argmin_2d on ties and NaN: card {seeds["cuda"]}, CPU {seeds["cpu"]}')
    if not seeds['cuda'] == seeds['cpu'] == ([0, 0, 0], [1, 0, 0]):
        raise RuntimeError('_argmin_2d: not the first index on ties and NaN')


def check_namespace():
    """The user namespace on the card's machine: `from phiflow_tpu_torch.flow import *` (without matplotlib or
    plotly where the machine has none), verify() on the card, detect_backends(), troubleshoot()."""
    import io
    from contextlib import redirect_stdout
    namespace = {}
    exec('from phiflow_tpu_torch.flow import *', namespace)
    import phiflow_tpu_torch
    buf = io.StringIO()
    with redirect_stdout(buf):
        phiflow_tpu_torch.verify()
    backends = phiflow_tpu_torch.detect_backends()
    report = phiflow_tpu_torch.troubleshoot()
    names = sorted(k for k in namespace if not k.startswith('_'))
    print(f'namespace: `from phiflow_tpu_torch.flow import *` gives {len(names)} names; verify(): '
          + ' | '.join(buf.getvalue().strip().splitlines()))
    print(f'namespace: detect_backends() {backends}; troubleshoot(): ' + ' | '.join(report.splitlines()))
    if 'torch-cuda:0' not in backends or 'CenteredGrid' not in namespace or 'plot' not in namespace \
            or 'basic field ops on cuda: OK' not in buf.getvalue():
        raise RuntimeError('the namespace, verify() or detect_backends() is wrong')


def run_splines():
    """Phase 12: spline-flip-128 and its CPU against the card, the spline shapes, transform_with_spline, the
    namespace (the spline obstacle is an entry of `check_obstacles_on_card`, phase 4h)."""
    import torch
    part = PhaseClock('part of phase')
    tag = f'spline-flip-{SPLINE_N}'
    by_path = {tag: run_solid_flip(tag, spline_setup, _spline_gaps, lambda: spline_cpu_vs_card(tag), SPLINE_N)}
    torch.cuda.empty_cache()
    part.done(f'12 {tag} and its CPU against card')
    check_splines_on_card()
    torch.cuda.empty_cache()
    part.done('12 the spline shapes and transform_with_spline on the card')
    check_namespace()
    part.done('12 the namespace')
    return by_path


class PhaseClock:
    """Seconds of each phase (or part of one) on the host clock, printed on a line of its own as it ends."""

    def __init__(self, what='phase'):
        self.what, self.t, self.seconds = what, time.perf_counter(), {}

    def done(self, phase):
        now = time.perf_counter()
        self.seconds[phase] = now - self.t
        print(f'{self.what} {phase}: {self.seconds[phase]:.1f} s')
        self.t = now


def card_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# the path whose run gives a kernel's `launches` in the `kernels` line: the one that brought it
COUNTED_ON = {**{k: 'fused' for k in FUSED_KERNELS}, 'window_interp_3d': 'per-phase',
              'window_interp_2d': 'per-phase-2d', 'poisson_stencil_masked': f'flip-{FLIP_N[0]}',
              'p2g': f'flip-{FLIP_N[0]}', 'p2g_mean': f'flip-{FLIP_N[0]}', 'poisson_stencil_coeffs': f'obstacle-{OBSTACLE_N}',
              'window_interp_3d_grad': 'grad-256', 'window_interp_2d_grad': 'grad-4096-2d',
              **{f'{k}_batched': f'batched-smoke-{BATCH_SMOKE_N}x{BATCH_B}' for k in BATCHED_KERNELS[:5]},
              'window_interp_2d_batched': 'batched-smoke-2d', 'window_interp_3d_grad_batched': 'batched-grad-64',
              'window_interp_2d_grad_batched': 'batched-grad-256-2d',
              'poisson_stencil_masked_batched': f'batched-obstacle-{BATCH_OBSTACLE_N}x{BATCH_OBSTACLE_B}'}
PATHS = [  # (tag, dims, N, per-phase?, the kernels it must launch)
    ('fused', 3, PATH_N, False, FUSED_KERNELS),
    ('per-phase', 3, PATH_N, True, PHASES_3D_KERNELS),
    ('per-phase-2d', 2, PATH_N_2D, True, PHASES_2D_KERNELS),
]


def main(argv):
    quick = '--quick' in argv
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 1
    from phiflow_tpu_torch.ops import _build
    clock = PhaseClock()
    card = card_line()
    print(f'card: {card}')
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}, '
          f'{torch.cuda.device_count()} visible device(s)')
    from phiflow_tpu_torch.native import _lib as native_lib
    gxx = {}
    gxx_thread = threading.Thread(target=lambda: gxx.update(s=native_lib.build(force=True)))
    gxx_thread.start()  # the mesh face matcher, built with g++ beside the nvcc processes
    try:
        t = _build.build(force=True, verbose=True)
    finally:
        gxx_thread.join()
    if 's' not in gxx:
        raise RuntimeError('the mesh face matcher (native/meshbuild.cpp) did not build')
    print(f'build: {len(_build.SOURCES)} sources in {t:.1f} s (one nvcc each, in parallel); the mesh face matcher '
          f'native/meshbuild.cpp with g++ beside them in {gxx["s"]:.1f} s')
    spilled = []
    for name in _build.SOURCES:
        with open(_build.ptxas_log(name)) as f:
            log = f.read()
        regs = [int(x) for x in re.findall(r'Used (\d+) registers', log)]
        spills = sum(int(x) for x in re.findall(r'(\d+) bytes spill stores', log))
        print(f'build: {name}.cu: {len(regs)} kernel instantiations, at most {max(regs)} registers '
              f'a thread, {spills} bytes of spill stores in all (ptxas -v)')
        for entry, n_regs, n_spill, n_load, stack in ptxas_entries(log):
            if 'march::stencil_kernel' in entry or 'window_interp' in entry or 'p2g' in entry:
                print(f'build: {name}.cu {entry}: {n_regs} registers, {stack} bytes stack frame, {n_spill} bytes '
                      f'spill stores, {n_load} bytes spill loads')
            if 'window_interp' in entry and '_grad_kernel' in entry and stack + n_spill + n_load:
                spilled.append(f'{entry}: a stack frame of {stack} bytes, spills {n_spill} / {n_load} bytes')
    if spilled:
        raise RuntimeError('K6T / K7T keep everything in registers and shared memory: ' + '; '.join(spilled))
    clock.done('1-2 card and build')
    ch = Checks()
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    t0 = time.perf_counter()
    part = PhaseClock('part of phase 3')
    for check in (check_poisson, check_poisson_masked, check_p2g, check_transfer, check_advect, check_interp,
                  check_interp_grad):
        check(ch, gen, quick)
        part.done(check.__name__)
    check_grid_nonfinite(ch, gen)
    part.done('check_grid_nonfinite')
    check_batched_kernels(ch, gen, quick)
    part.done('check_batched_kernels')
    if not quick:
        time_vcycle_levels(ch, gen)
        time_p2g(ch, gen)
        check_p2g_grad(ch)
        part.done('time_vcycle_levels, time_p2g, check_p2g_grad')
    torch.cuda.synchronize()
    print(f'checks: {time.perf_counter() - t0:.1f} s, {sum(ch.passed.values())} passed, {len(ch.failed)} failed')
    if ch.failed:
        raise RuntimeError(f'kernel checks failed: {ch.failed}')
    clock.done('3 kernels against their twins (and 9a)')
    if quick:
        return 0
    by_path = {}
    part = PhaseClock('part of phase')
    for tag, dims, N, per_phase, required in PATHS:
        by_path[tag], state, iters = run_slice(tag, dims, N, per_phase, required)
        if tag == 'per-phase':
            phase_state, phase_iters = state, iters
        del state
        torch.cuda.empty_cache()
    by_path['per-phase-field'] = run_field('per-phase-field', PATH_N, phase_state, by_path['per-phase'], phase_iters)
    field_against_array(PATH_N, phase_state)
    torch.cuda.empty_cache()
    part.done('4a-4c smoke paths and 4-field')
    for N in FLIP_N:
        by_path[f'flip-{N}'] = run_flip(f'flip-{N}', N)
        torch.cuda.empty_cache()
    part.done('4d-4e FLIP')
    tag = f'terrain-flip-{TERRAIN_N}'
    by_path[tag] = run_solid_flip(tag, terrain_setup, _terrain_gaps, lambda: solid_flip_cpu_vs_card(
        tag, terrain_setup, _terrain_gaps, {'the terrain': (None, True)}), TERRAIN_N)
    check_geometry_on_card()
    check_obstacles_on_card()
    torch.cuda.empty_cache()
    part.done(f'4h terrain-flip-{TERRAIN_N} and the geometry on the card')
    by_path[f'obstacle-{OBSTACLE_N}'] = run_obstacles(f'obstacle-{OBSTACLE_N}', OBSTACLE_N)
    torch.cuda.empty_cache()
    by_path[f'obstacle-{OBSTACLE_N}-vcycle'] = run_obstacles(f'obstacle-{OBSTACLE_N}-vcycle', OBSTACLE_N, warmup=1,
                                                             steps=3, preconditioner='vcycle')
    torch.cuda.empty_cache()
    from phiflow_tpu_torch.models import LidDrivenCavity, MovingObstacles
    by_path['moving-obstacles-2d'] = run_model_2d('moving-obstacles-2d', MovingObstacles(256, device='cuda'))
    by_path['cavity-2d'] = run_model_2d('cavity-2d', LidDrivenCavity(256, obstacle=True, device='cuda'))
    part.done('4f-4g obstacles and the 2D obstacle models')
    by_path.update(run_grid_models(ch))
    part.done('4 2D grid models')
    by_path.update(run_sph_models())
    part.done('4 SPH')
    by_path.update(run_fvm_models())
    part.done('4 FVM')
    print_path_gaps(ch, by_path)
    clock.done('4 paths')
    cpu_vs_card('fused', 3, 64, False)
    cpu_vs_card('per-phase', 3, 64, True)
    cpu_vs_card('per-phase-2d', 2, 256, True)
    part.done('5 smoke paths')
    flip_cpu_vs_card()
    part.done('5 FLIP')
    obstacles_cpu_vs_card()
    obstacles_cpu_vs_card(preconditioner='vcycle')
    part.done('5 obstacles')
    field_cpu_vs_card('per-phase-field', 3, 64)
    field_cpu_vs_card('per-phase-field-2d', 2, 256)
    field_obstacle_against_array()
    part.done('5 Field paths')
    clock.done('5 CPU against card')
    by_path.update(run_gradients(ch))
    clock.done('6 gradients')
    by_path.update(run_optimisation())
    clock.done('7 optimisation')
    by_path.update(run_solvers(ch))
    clock.done('8 solvers and projections')
    by_path.update(run_batched(ch, gen))
    clock.done('9 batched simulation')
    by_path.update(run_open_boundaries(ch))
    clock.done('10 open boundaries')
    by_path.update(run_mesh_and_io())
    clock.done('11 mesh slice, I/O and utilities')
    by_path.update(run_splines())
    clock.done('12 splines and the namespace')
    if '--profile' in argv:
        for tag, dims, N, per_phase, _ in PATHS:
            profile_slice(tag, dims, N, per_phase)
        profile_field('per-phase-field', PATH_N, phase_state)
        for N in FLIP_N:
            profile_flip(f'flip-{N}', N)
        profile_obstacles(f'obstacle-{OBSTACLE_N}', OBSTACLE_N)
        profile_obstacles(f'obstacle-{OBSTACLE_N}-vcycle', OBSTACLE_N, 'vcycle')
        profile_grid_models()
        profile_sph()
        profile_fvm()
        profile_gradient('grad-256', 3, PATH_N, 3)
        profile_gradient('grad-4096-2d', 2, PATH_N_2D, 2, period=PATH_N, cg_tol=GRAD_CG_TOL_4096)
        time_smooth_chunks(gen)
        time_march_chunks(gen)
    rows = []
    for name, (source, replaces) in ROWS.items():
        counter = BATCHED_ROWS.get(name, name)
        rows.append(dict(name=name, route='cuda', source=source, replaces=replaces,
                         launches=int(by_path[COUNTED_ON[name]].get(counter, 0)), launches_path=COUNTED_ON[name],
                         launches_by_path={tag: int(c.get(counter, 0)) for tag, c in by_path.items()},
                         max_abs_err=ch.max_err[name], checks_passed=ch.passed[name], **ch.timing[name]))
    print(f'phases: ' + ', '.join(f'{k} {v:.1f} s' for k, v in clock.seconds.items())
          + f'; {sum(clock.seconds.values()):.1f} s in all')
    print(f'card: {card}')
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
