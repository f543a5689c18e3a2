#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero; no phase catches and carries on):
  1. device: needs CUDA; prints the card's name and power limit;
  2. build: compiles the hand-written kernels of ground_fusion2_tpu_torch/csrc
     with nvcc (sm_90a, one process a source) and prints the build seconds;
  3. camera kernels: A-C and L against their plain PyTorch versions at the
     camera path's shapes (CLAHE 480×640, KLT F = 150 on two consecutive
     rendered frames, the projection normal equations (C) and those of the
     other rows (L) on an example window F = 150 / D = 396), with the stated
     tolerances and the median time of both; C twice on the same inputs,
     and L's closure of a solve beside its one-shot form, give the same
     bits. Kernel W, the damped Cholesky solve, on the
     window's LM step at D = 396 (against float64, within 10× the plain
     cuSOLVER route's error there; NaN on a non-PD input; the same bits
     twice) and kernel X, the float64 eigensolver, through marginalize on
     the window's MARGIN_OLD (drop 170 / keep 226) and MARGIN_SECOND_NEW
     (drop 20 / keep 226): the prior's H* and g* within 1e-9 of the eigh
     route's, the same bits twice, its device ms by stage
     (tridiagonalization, divide and conquer, back-transform; torch.profiler)
     beside eigh's at each size. Kernel S, the window's cost, at
     delta = 0, at the damped LM step from there and at its reverse: within
     max(3× the plain route's error, 1e-6) of a float64 evaluation, the
     same bits twice, the step accepted and its reverse rejected by both
     routes;
  4. camera path: FusedVio.process_image with the M3DGR configuration
     over 32 rendered 640×480 frames of the bench.py room drive (RGB-D + IMU
     + wheel), twice from the same frames. Each run must initialize, run ≥ 20
     fused ticks, launch A-C, H-L, S-X and AH-AJ, AN, AO during them (H
     with Y's square-root informations in its blocks and S with AN's step
     in its last CTA: Y's and AN's step's own launches must stay at 0),
     make no synchronizing CUDA call on any tick with the window full (the
     slide chosen on the device; the record's read, the tick's output
     reaching the host, aside), take both MARGIN_OLD and
     MARGIN_SECOND_NEW on such ticks, call
     torch.func.jacfwd and the plain window cost no time (nor, with the
     counter below, any torch.linalg eigensolver, which the plain
     triangulation's [F, 4, 4] eigh was), stay finite, and keep the aligned ATE
     < 0.30 m; both ATEs, the JAX package's on the same drive beside them
     (not gated) and the first tick where the two runs' windows differ are
     printed. Kernels C and L are also held against their plain
     versions on the final window;
  5. LiDAR path: LidarOdometry.process_scan with the M3DGR LIO
     configuration (map 1<<17 points, K = 2000 keypoints, 5 CT-ICP
     iterations) over 60 scans of the bench_lio room drive (4096 rays,
     5 mm noise, seed 0, 20 IMU samples a scan), the sensor 1 m above the
     floor. It must initialize, run ≥ 50 fused ticks, launch D-G (a GN
     iteration is D (the keypoints' transform, then the weights) → E (Y's
     damped solve in its last CTA, then the step); Y's own solve launch
     never) and the glue kernels AK (once a tick: the scan's points), AL
     (the keypoint and voxel-map glue around F) and AM
     (the ESKF's observations, the select, the switch and the record)
     during them, stay finite, flag no scan degenerate after the second,
     sync the host once a tick (the record read), and keep the position
     error after aligning the first output < 0.06 m; the last 3 ticks'
     launches and device ms by kernel are printed (torch.profiler) and AK
     must launch once a tick there. Then
     kernel Y against its plain versions: the ESKF's 6×6 innovation
     inverse (the plain route's; AM runs the same device code), CT-ICP's
     damped 12×12 solve (its standalone launch; E runs the same device
     code) and degeneracy test on the next scan's inputs, the square-root
     informations of phase 4's final window (each against float64 within
     max(1e-5, 3× the plain route's error), the flags equal unless within
     1e-4 of a threshold);
  6. LiDAR kernels: D-G against their plain versions on the map the drive
     filled, at K = 2000 and M = 48, and E with the solve against E alone
     and Y's launch bit for bit (F also through an insert, an insert
     that overflows capacity and a recenter, bit-exact against the CPU);
     AK's points (keypoints, the scan), weights and step (from done = 0,
     frozen, at the midpoint with and without a re-gather), and AK folded
     into D and E bit for bit against its standalone modes
     (checks.check_ct_fold: D's CT-ICP entry at 1, 33, 2000 and 2048
     keypoints in every mode, E's step in each step case and on a NaN
     step; the device ms of both beside the launches they replace), AL's every
     mode (kp_codes, kp_first, kp_take, ins_key, permute, dedup, drop,
     compact, rc_key, ev_key; and an insert, an overflowing insert, a
     recenter and an eviction on the card against the CPU) and AM through a
     scripted sequence of (degenerate, external pose) inputs that takes
     the switch through all four branches (entering with and without an
     external pose, staying, exiting) and the filter through its three
     observe selects, the recenter predicate both ways: every output
     torch.equal to the plain route's, twice the same bits;
  7. camera kernels H-K against their plain versions: H on the final
     camera carry's 10 intervals, I on frame 12, J and K on the KLT tracks
     of frames 12 -> 13 (K's device ms, launches and Jacobi sweeps a
     hypothesis printed); kernel O and its cost-only mode on a 500-node
     graph at the 4·512 tier (twice: the same bits), and W on the pose
     graph's systems at 4·64 and 4·512; T, U and V on phase
     4's final carry (T on every live track with the depth fix cleared, U
     before and after the solve, V's add_frame and both slides), each
     twice for the same bits;
  8. the system: GroundFusion(m3dgr_system()) over 40 frames of the
     bench.py bench_system drive, each frame process_camera_image then
     process_lidar, then flush. Both estimators must initialize, ≥ 20
     system ticks run with both carries live, A-K launch during them,
     every fused pose stay finite, no scan after the second be degenerate,
     the fused position error after aligning the first output stay
     < 0.06 m and the VIO's aligned ATE < 0.30 m. Over the last 3 ticks
     torch.profiler prints the device time a tick of the port's kernels
     (F's, C's, L's with P's, W's, X's and AC's summed under
     by_kernel_ms_per_tick),
     torch.linalg's and every other kernel, and the launches a tick (and
     of kernels AH, AI, AJ, U, Y, H, S and AN beside their device ms), and
     split the same by profiler range (utils/profiling.py stage: each
     stretch of the tick named after the JAX function it ports, every CUDA
     activity given to the innermost range open at its launch), with the
     synchronizing calls a tick by call site, and the LiDAR tick's own
     ranges (select_keypoints, ct_icp, observe_switch, record, map_update)
     with AK's, AL's and AM's launches and device ms a tick; the
     torch.linalg class must be empty;
  8b. the tick's glue kernels on the card against their plain routes:
     AH (frontend/track_tail.py: lift, kill, tail) on phase 4's frames 12
     → 13 with a dynamic-mask box, at the configuration's camera and a
     distorted one, the tail also with t = prev_t; AI (vio/window_carry.py)
     on phase 8's final carry, the write at two columns and the slide in
     each branch, MARGIN_SECOND_NEW also past M = 128 samples; AJ
     (solver/marginalize.py) on phase 8's final window, MARGIN_OLD and
     MARGIN_SECOND_NEW with the layout's device tables, both routes on
     kernel X. Every output torch.equal to the plain route's, the same
     bits twice. Then the camera tick's two folds
     (checks.check_preint_lm_fold): H with Y's square-root informations
     against H then Y (phase 8's final window, an interval with no valid
     sample, a covariance not positive definite) and S with AN's step
     against S then AN's step (an accept, a reject, a tie, a NaN cost, λ
     at each clamp), torch.equal, with each fold's device ms and launches
     beside the chain's;
  9. the loop-closure path: GroundFusion with loop closure on (the M3DGR
     camera configuration, PoseGraphConfig at its defaults but num_feats
     150: sim_thresh 0.88, skip_recent 50, 128 hypotheses, capacity 512,
     4-DoF) over checks.loop_drive(60): tests/test_system_loop.py's closed
     circle (radius 1.2 m in make_room_scene(seed=0)) rendered at 640×480
     with the M3DGR intrinsics, the odometry drifting 0.10 rad and (0.18,
     -0.12, 0) m. The VIO is a scripted pose source emitting the drifted
     poses, all keyframes, as the JAX package's own system test does: a
     real VIO needs more than 50 keyframes before a loop can be tried, at
     about a second a tick longer than this script's time. M, N and O must
     launch, a loop_closed event fire, and the published endpoint error stay
     under 0.6× the raw odometry's (tests/test_system_loop.py:106); then M,
     N and O are held against their plain versions on the phase's data (the
     last keyframe's corners, the loop's matches, the final graph's edges),
     and W on the final graph's system at its tier (4·64);
 10. GNSS + global fusion: GroundFusion at groundchallenge_gnss() (the
     Ground-Challenge camera configuration with raw GNSS; F = 150, S = 16
     satellite slots, 8 LM iterations) with global fusion every 5 keyframes
     (capacity 256, a 1536-dim LM, 6 iterations) and LiDAR off, over the 139
     frames of checks.gnss_drive: tests/test_gnss_fused.py's drive (14 s,
     IMU noise, a GnssSim sky through yaw 0.3, seed 7) with each epoch's SPP
     fix as gps_enu, through process_camera. It must initialize, complete
     GNSS-VI alignment, run ≥ 60 fused ticks with gnss_enabled 1 on some,
     launch P and Q, stay finite and run ≥ 3 global_opt events; the
     unaligned ATE after init < 0.30 m and within 0.05 m of JAX's run at the
     port's float64 elimination of the marginalization, the yaw within 0.05
     rad of 0.3, the graph nodes' RMS error to the truth in the first fix's
     ENU frame ≤ 1.5× JAX's + 0.05 m. Over the last 3 ticks torch.profiler
     prints L's and P's device ms and launches a tick beside the tick's. W
     and X must launch; the eigenvalues
     of every marginalization within a factor 10 of the 1e-6 gates are
     counted and printed; W is held on the final global graph's system
     (6·256 = 1536). The comparison with the JAX package's own (float32)
     ATE is printed and does not fail the run: that figure rests on its
     own eigh's rounding in the prior's weakly observed directions, which
     no elimination of the port reproduces, in float64 or in float32 (a
     reference behaviour, ROADMAP.md queue 3);
 10b. the GNSS anchor refresh and yaw refine: GroundFusion at
     groundchallenge_gnss() with the refresh bound at 0.45 m and a refine
     every 4 GNSS ticks over 45 frames of checks.gnss_drive with an epoch on
     every frame; both must fire (a refine counts once it has the 10
     velocity pairs it needs), on the frames the JAX package fires them on,
     and each refined yaw must lie within 0.01 rad of JAX's with its
     elimination in float64, as the port eliminates;
 11. the dynamic mask: GroundFusion(m3dgr_system() with auto_dyn_mask) over
     checks.dynamic_drive(40) (the system drive with scenarios.py's
     160-px occluder at 1.2 m sweeping the image for 3 s), each frame
     process_camera_image then process_lidar. R must launch; on every tick
     with the occluder in view after the first the mask covers ≥ 70 % of it
     and no live tracker slot sits on it; the fused error < 0.06 m and the
     VIO ATE < 0.30 m; the mask's share on occluder-free ticks is printed
     beside JAX's;
 12. P on phase 10's final window, which must have the GNSS gate on and
     live GNSS rows (H to 1e-5 of its largest entry, g against
     sqrt(H_ii·2·cost), the cost against a float64 evaluation to 3× the
     plain route's error there, twice the same bits), Q on phase 10's final
     global graph (1e-5, twice the same bits), R on a phase-11 frame pair
     (equal, or differing only beside a blurred residual within 1e-5 of its
     threshold), Q's cost-only mode on the same graph, S on the final
     GNSS window at delta = 0 and at an LM step (timed), and W and X on that
     window's damped step and eliminations;
 13. the occupancy grid: GroundFusion(m3dgr_system() with
     use_occupancy_grid) over phase 8's drive, each frame
     process_camera_image then process_lidar. Kernel Z must launch once a
     fused sweep; on the last sweep it is held against its plain version
     (every sample's cell equal, each cell within the rounding bound of
     its sums); the occupied (p > 0.65) and free (p < 0.2) cell counts are
     printed beside the JAX package's on the same drive
     (tests/torch_system_reference.py), save_grid_map then
     OccupancyGrid.load must give prob() back within 1/255, and the system
     tick with the grid on is printed beside phase 8's and beside the same
     drive with the grid off right after it, with phase 8's torch.profiler
     split of the last 3 ticks and the grid feed's host wall;
 14. the online mesh: GroundFusion(m3dgr_system() with use_mesh at the JAX
     package's MeshConfig() defaults and the M3DGR intrinsics as
     mesh_intrinsics) over phase 8's drive, each frame process_camera_image
     then process_lidar with the grey frame as a three-channel texture and
     the latest VIO pose composed with the rig's extrinsic as its camera
     pose (checks.mesh_texture, as data/m3dgr_sim.py:392-404), then flush.
     AA must launch on every insert chunk, AB on every textured sweep, AC
     once a drain (one launch over every pending voxel); every fused pose stay finite and the fused error < 0.06 m; AA, AB
     and AC are held against their plain versions on the last chunk, the
     last textured sweep and the last drain's voxels (AA's means bit for bit
     against the CPU's pass; AB's visibility equal but within 1e-5 of a
     border, colours to 1e-3; AC's verdicts equal but where a test's margin
     is within 1e-5 of its terms, each such triple named, and bit for bit
     the launches of 32 voxels on the same codes; each twice the same
     bits); export_mesh's PLY header counts must equal stats(). AC's
     launches a drain, its device ms a tick and the syncs a sweep by call
     site are printed. The mesh's vertices, meshed voxels and triangles and
     its textured share are printed beside the JAX package's on the same
     drive (tests/torch_system_reference.py mesh), and the system tick
     beside phase 8's, with the mesh feed's host wall and syncs a sweep and
     torch.profiler's split of the last 3 ticks;
 15. the line path (frontend/lines.py): detect_lines on each of the 32
     frames of phase 3's drive (grey ÷ 255) and track_lines on each
     consecutive pair with 3-level pyramids. AD must launch once a frame, AE
     twice a pair, B once a pair; the valid and tracked segments, printed
     beside the JAX package's on the same frames (tests/
     torch_lines_reference.py), must total within 2 % of its. AD, AE and B
     (at the line path's arguments) are held against their plain versions
     on the last pair (AD's thresholds bit for bit, the flags equal but
     where a test's margin is within 1e-5 of its terms, each such segment
     named; AE's samples bit for bit; twice the same bits);
 16. the distributed solves over a one-rank NCCL group (FileStore):
     make_distributed_solver (8 LM iterations) on the F = 150 example window
     (D = 396) must end within 0.02 m of the port's solve_window result and,
     started from that result, stay within 1e-4 m (tests/test_dist_ba.py's
     gates); make_mapping_solver at K = 64, 128 landmarks a keyframe, halo 3
     (tools/bench_weak_scaling.py's widths: 8,192 landmarks, 384 dims),
     seed 1, perturbation 0.05, 6 iterations, must bring every pose within
     0.01 m of the truth and the cost under 1e-4 (tests/
     test_dist_mapping.py's gates), printed beside the JAX package's figure
     (tests/torch_parallel_reference.py). AF and AG must launch; AF, AG and
     W's explicit-diagonal mode are held against their plain versions on
     both problems (twice the same bits). The card is one: the multi-rank
     collectives and the halo's send/recv run only over gloo in the CPU
     tests.
 17. the camera models: kernel AH's lift and tail modes for five cameras,
     one a model (configs/hilti22.yaml's Equidistant at 720×540 and
     configs/idc.yaml's radtan Pinhole through the port's loader,
     tests/test_cameras.py's Mei, PinholeFull and Scaramuzza), F = 150
     slots drawn over the whole image from a seed (tracked, dead and
     fresh): every output torch.equal to the plain route and finite, twice
     the same bits, each mode's device ms and launches a model printed.
     Then phase 4's drive once with the M3DGR intrinsics as a PinholeFull
     of zero coefficients: its windows must equal phase 4's first run's,
     tick for tick, with no synchronizing call on a full tick. No fisheye
     rig is driven: the renderer, a copy of the JAX package's, is
     pinhole-only;
 18. the chessboard calibration: calibrate_pinhole_full and
     calibrate_pinhole on 40 views of a 12 × 8 board with 3 cm squares
     (checks.calib_views: tests/test_calib_intrinsics.py's pose draw and
     cameras; 7,680 rows, D = 252 and 248), then calibrate_pinhole again
     on the radtan views with 0.3 px of Gaussian noise (the JAX suite's
     test_calibration_with_pixel_noise), where the rms and the final cost
     sit far above float32 rounding. Each must reach rms < 0.1 px and fx fy
     cx cy within 1.5 px (rational) or 2 px (radtan) of the truth, the
     noisy one rms < 0.6 px and fx cx within 8 px (the JAX suite's gates),
     launch AP, W and AN and call torch.func.jacfwd no time; its wall, device
     ms and launches are printed. Kernel AP is held against its plain
     version (jacfwd, then JᵀJ) at δ = 0 and at the LM's final δ within
     checks.calib_tolerances (H within 1e-5 of its largest entry), twice
     the same bits, its cost mode equal to its normal mode's cost;
 19. the stereo window (checks.stereo_window: the example window at F =
     150, W = 11 and a second camera 0.05 m along the first's x axis, its
     rays and mask built by numpy from a seed): kernel C's stereo family
     against its plain route within PROJ_REL_TOL / PROJ_G_TOL, kernel S's
     at the start, the damped step and its reverse within its cost
     tolerances, then solve_window and marginalize_oldest with use_stereo:
     positions under 0.01 m of the truth (tests/test_window_ba.py's gate),
     a finite prior, C and S launched, no synchronizing call;
 20. kernel AQ (JAX's threefry draws): the tick's [64, 150] uniforms from
     a device word, a seed's Gumbel noise and the loop's 128 split keys and
     their noise, each torch.equal to the plain route (core/prng.py) and to
     jax 0.9.0's recorded answers (checks.JAX_PRNG_ANSWERS), beside
     torch.rand's time at the tick's shape. Phase 8 requires AQ launched on
     the live ticks, phase 9 its split mode on the loop drive.
Phases 4, 5, 8, 9, 10, 10b, 11, 13, 14, 15, 16, 17, 18 and 19 run with a counter on every
torch.linalg function but the norms and cross, and on torch's own
factorizations, solves and inverses (cholesky_solve, cholesky_inverse,
inverse, lu_solve, ...): every count must be 0, each kernel W-Z replacing
its call. Phases 4, 8, 10, 11 and 13 also fail on a non-finite
marginalization prior (kernel X's NaN where its secular iterations do not
converge; phase 10 on any unconverged eigensolve).
Every timed check reports the host-inclusive call ms (CUDA events around
one call) and the device ms a call with the launches a call
(checks.device_ms: torch.profiler's CUDA activities of 20 warm calls), the
kernel's and, where one PyTorch call computes the same function, that
call's, measured in turns (kernel, library, library, kernel). Phase 3
prints kernel C's device ms and launches a call; phase 6 kernel F's beside
torch.sort(stable=True)'s at each of the main path's sorts (the map's
codes, subcells and squared distances at 135,168 keys, the recenter's
131,072, a mesh-sized 69,632, the keypoints' hash codes and flags); phase
14 F's on the mesh's own 69,632 codes.
The last two lines are the kernels JSON (launches from phase 8's run for
A-L, S-Y, AH-AO and AQ (Y's inverse entry serves the plain route alone: its
device code runs inside AM; its square-root informations run inside H, whose
launches that ran them the sqrt_info entry adds as inside_launches; AN's
step inside S, the lm_glue entry's step_inside_launches), phase 9's for M-O and O's cost mode, phase 10's for P, Q and
Q's cost mode, phase 11's for R, phase 13's for Z, phase 14's for AA-AC,
phase 15's for AD and AE, phase 16's for AF and AG, phase 18's for AP,
phase 19's for C's and S's stereo family) and
the result JSON.

The camera rig is synthetic: the renderer's forward camera (bench.py's
extrinsic) and an identity wheel frame replace the M3DGR extrinsics, which
describe another physical mount; intrinsics, F, noise and factor flags are
M3DGR's. Phase 10's rig is the simulated camera's (tests/test_gnss_fused.py)
with an identity wheel frame in place of the Ground-Challenge extrinsics.
The LiDAR drive lifts bench_lio's sensor off the floor: at floor level the
scan sees no floor, and every scan is degenerate (σ_min < 7) in the JAX
package as well.
"""

import collections
import json
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np

CAM_FRAMES = 32
LIO_SCANS = 60
LIO_Z = 1.0            # sensor height above the room's floor, m
LIO_MAX_ERR = 0.06     # m, test_lio_e2e.py's bound; the JAX package: 0.0032 m
# the JAX package's FusedVio on phase 4's drive, aligned ATE over its 22
# initialized frames (tests/torch_system_reference.py camera, CPU); printed
# beside phase 4's, not gated
JAX_CAMERA_ATE = 0.09645292800512928
# the port's FusedVio on the CPU over the same drive with its own RANSAC
# draws, JAX's (tests/torch_system_reference.py port-jax-draws); printed
# beside phase 4's, not gated
PORT_CPU_ATE = 0.14668776783459836
SYS_FRAMES = 40
SYS_MAX_ERR = 0.06     # m, fused position error (test_lio_e2e.py's bound)
SYS_MAX_ATE = 0.30     # m, the VIO's aligned ATE
# preint_sqrt_info: kernel H's launches whose blocks run Y's square-root
# informations; window_cost_step: kernel S's launches whose last CTA runs
# AN's LM step (the routes of Y's factor and AN's step on the camera tick)
CAMERA_KERNELS = ("clahe", "klt", "proj_normal", "preint", "pyramid",
                  "shi_tomasi", "detect_grid", "ransac_f", "small_normal",
                  "window_cost", "triangulate", "window_tests", "window_update",
                  "chol_solve", "sym_eig", "preint_sqrt_info", "track_tail",
                  "window_carry", "marg_schur", "lm_glue", "tick_glue",
                  "threefry", "window_cost_step")
# phases 4 and 8: Y's standalone square-root informations and AN's
# standalone step never launch on a camera tick
CAMERA_OFF_PATH = ("sqrt_info", "lm_step")
LOOP_KERNELS = ("brief", "simhash", "hamming", "loop_geom", "pg_normal",
                "pg_cost")
GNSS_KERNELS = ("gnss_normal", "global_normal", "global_cost")
RR_FRAMES = 45         # phase 10b: tests/test_torch_gnss_fused.py's refresh
RR_REFRESH_M = 0.45    # and refine drive (an epoch every frame), its bounds
RR_PERIOD = 4
# the JAX package on phase 10b's drive (tests/torch_gnss_reference.py
# refresh / refresh-f64, CPU): the frames each branch fired on and the yaw
# after each refine, with its float32 elimination and in float64 (the
# port's precision, which the gate holds; the port on the CPU: within 9.6e-4)
JAX_RR = dict(refresh=[25, 30, 35, 40], refine=[35, 39, 43],
              yaw=[0.34168344736099243, 0.3385225832462311, 0.34762704372406006],
              yaw_f64=[0.3999084234237671, 0.4013034701347351,
                       0.41415417194366455])
RR_YAW_TOL = 0.01      # rad, each refine's yaw against JAX's at float64
MASK_KERNELS = ("dyn_mask",)
# the JAX package on the same drives (tests/torch_gnss_reference.py, CPU);
# ate_f64 and global_rms_f64: its run with the marginalization's elimination
# in float64, the port's precision ("gnss-f64"), which the ATE gate holds
JAX_GNSS = dict(ate=0.009414173042220295, yaw=0.3224187195301056,
                global_rms=0.39743287667556765, align_tick=55, global_opt=24,
                ate_f64=0.07427199801716776, global_rms_f64=0.4062973070155852)
JAX_MASK_FREE = dict(mean=0.014753787878787878, max=0.16229166666666667)
# the JAX package's occupancy grid on phase 8's drive (p > 0.65 / p < 0.2;
# tests/torch_system_reference.py, CPU)
JAX_GRID = dict(occupied=1079, free=63662)
# the JAX package's mesh on phase 14's drive and feed, and the share of its
# live vertices that took a colour (tests/torch_system_reference.py mesh,
# CPU)
JAX_MESH = dict(stats=dict(vertices=32178, voxels_meshed=2979,
                           triangles=42979, frames=36, evicted_vertices=0),
                textured=0.3044005220958419)
GNSS_MAX_ATE = 0.30    # m, tests/test_gnss_fused.py:29
GNSS_YAW_TOL = 0.05   # rad, tests/test_gnss_fused.py:73
MASK_COVER = 0.7       # tests/test_dynamic_mask.py:57
DYN_FRAMES = 40
LOOP_KEYFRAMES = 60
LOOP_MAX_RATIO = 0.6   # published / raw endpoint error (test_system_loop.py)
# ct_icp_solve: kernel E's launches whose last CTA runs Y's damped solve
# (icp_solve_warp.cuh), the solve's only route on the path
LIDAR_KERNELS = ("lio_assoc", "ct_icp_normal", "radix_sort", "eskf_predict",
                 "ct_icp_solve", "degeneracy", "ct_glue", "voxel_glue",
                 "lio_update")
# phase 5: each launched during the drive; Y's standalone solve never
LIO_PATH_KERNELS = ("lio_assoc", "ct_icp_normal", "ct_icp_solve",
                    "radix_sort", "eskf_predict", "ct_glue", "voxel_glue",
                    "lio_update")
LIO_OFF_PATH = ("icp_solve",)
# kernel AK's launches a LiDAR tick: the scan's transform for the map
# insert (the CT-ICP loop runs AK's device code in kernels D and E)
LIO_AK_PER_TICK = 1
# save_grid_map -> load: one PGM grey level (the writer truncates) and the
# float32 rounding of the logit and sigmoid around it
OCC_MAX_DIFF = 1.0 / 255.0 + 1e-6
PKG = "ground_fusion2_tpu_torch/csrc/"
DEVICE = "cuda:0"
SOURCES = {   # kernel: (source, the TPU kernel's function it replaces)
    "clahe": ("clahe.cu", "ground_fusion2_tpu/frontend/clahe.py:33"),
    "klt": ("klt.cu", "ground_fusion2_tpu/frontend/klt.py:234"),
    "proj_normal": ("proj_normal.cu",
                    "ground_fusion2_tpu/solver/gauss_newton.py:50"),
    "lio_assoc": ("lio_assoc.cu", "ground_fusion2_tpu/lio/voxel_map.py:196"),
    "ct_icp_normal": ("ct_icp_normal.cu",
                      "ground_fusion2_tpu/lio/ct_icp.py:122"),
    "radix_sort": ("radix_sort.cu", "ground_fusion2_tpu/lio/voxel_map.py:80"),
    "eskf_predict": ("eskf_predict.cu", "ground_fusion2_tpu/lio/eskf.py:86"),
    "preint": ("preint.cu", "ground_fusion2_tpu/sensors/imu_preint.py:121"),
    "pyramid": ("pyramid.cu", "ground_fusion2_tpu/frontend/klt.py:39"),
    "shi_tomasi": ("pyramid.cu", "ground_fusion2_tpu/frontend/klt.py:65"),
    "detect_grid": ("detect_grid.cu", "ground_fusion2_tpu/frontend/klt.py:78"),
    "ransac_f": ("ransac_f.cu", "ground_fusion2_tpu/frontend/ransac.py:58"),
    "small_normal": ("small_normal.cu",
                     "ground_fusion2_tpu/solver/gauss_newton.py:50"),
    "brief": ("brief.cu", "ground_fusion2_tpu/posegraph/brief.py:47"),
    "simhash": ("brief.cu", "ground_fusion2_tpu/posegraph/brief.py:68"),
    "hamming": ("brief.cu", "ground_fusion2_tpu/posegraph/brief.py:77"),
    "loop_geom": ("loop_geom.cu",
                  "ground_fusion2_tpu/posegraph/pose_graph.py:432"),
    "pg_normal": ("pg_normal.cu",
                  "ground_fusion2_tpu/posegraph/pose_graph.py:514"),
    "gnss_normal": ("small_normal.cu", "ground_fusion2_tpu/gnss/factors.py:137"),
    "global_normal": ("global_normal.cu",
                      "ground_fusion2_tpu/gnss/global_opt.py:70"),
    "dyn_mask": ("dyn_mask.cu", "ground_fusion2_tpu/frontend/dynamic.py:79"),
    "window_cost": ("window_cost.cu",
                    "ground_fusion2_tpu/solver/gauss_newton.py:107"),
    "triangulate": ("triangulate.cu",
                    "ground_fusion2_tpu/vio/feature_window.py:227"),
    "window_tests": ("window_tests.cu",
                     "ground_fusion2_tpu/vio/feature_window.py:269"),
    "window_update": ("window_update.cu",
                      "ground_fusion2_tpu/vio/feature_window.py:60"),
    "pg_cost": ("pg_normal.cu", "ground_fusion2_tpu/posegraph/pose_graph.py:514"),
    "global_cost": ("global_normal.cu",
                    "ground_fusion2_tpu/gnss/global_opt.py:104"),
    "chol_solve": ("chol_solve.cu",
                   "ground_fusion2_tpu/solver/gauss_newton.py:61"),
    "sym_eig": ("sym_eig.cu", "ground_fusion2_tpu/solver/marginalize.py:88"),
    "sqrt_info": ("small_linalg.cu",
                  "ground_fusion2_tpu/factors/vio_factors.py:115"),
    "icp_solve": ("small_linalg.cu", "ground_fusion2_tpu/lio/ct_icp.py:143"),
    "degeneracy": ("small_linalg.cu", "ground_fusion2_tpu/lio/ct_icp.py:180"),
    "occupancy": ("occupancy.cu", "ground_fusion2_tpu/mapping/occupancy.py:51"),
    "mesh_insert": ("mesh_insert.cu",
                    "ground_fusion2_tpu/mesh/incremental.py:123"),
    "mesh_rgb": ("mesh_rgb.cu", "ground_fusion2_tpu/mesh/incremental.py:198"),
    "mesh_delaunay": ("mesh_delaunay.cu",
                      "ground_fusion2_tpu/mesh/incremental.py:348"),
    "track_tail": ("track_tail.cu", "ground_fusion2_tpu/vio/fused.py:183"),
    "window_carry": ("window_carry.cu", "ground_fusion2_tpu/vio/fused.py:297"),
    "marg_schur": ("marg_schur.cu",
                   "ground_fusion2_tpu/solver/marginalize.py:57"),
    "ct_glue": ("ct_glue.cu", "ground_fusion2_tpu/lio/ct_icp.py:56"),
    "voxel_glue": ("voxel_glue.cu", "ground_fusion2_tpu/lio/fused.py:240"),
    "lio_update": ("lio_update.cu", "ground_fusion2_tpu/lio/eskf.py:165"),
    "lm_glue": ("lm_glue.cu", "ground_fusion2_tpu/solver/gauss_newton.py:85"),
    "tick_glue": ("tick_glue.cu", "ground_fusion2_tpu/vio/fused.py:297"),
    "threefry": ("threefry.cu", "ground_fusion2_tpu/vio/fused.py:198"),
    # the stereo rows' family of C and S (phase 19's window)
    "proj_normal_stereo": ("proj_normal.cu",
                           "ground_fusion2_tpu/factors/vio_factors.py:247"),
    "window_cost_stereo": ("window_cost.cu",
                           "ground_fusion2_tpu/factors/vio_factors.py:247"),
}
MESH_KERNELS = ("mesh_insert", "mesh_rgb", "mesh_delaunay")
SOURCES.update({
    "line_detect": ("line_detect.cu", "ground_fusion2_tpu/frontend/lines.py:56"),
    "line_refit": ("line_refit.cu", "ground_fusion2_tpu/frontend/lines.py:124"),
    "dist_schur": ("dist_schur.cu",
                   "ground_fusion2_tpu/parallel/dist_ba.py:55"),
    "map_schur": ("map_schur.cu",
                  "ground_fusion2_tpu/parallel/dist_mapping.py:95"),
    "calib_normal": ("calib_normal.cu",
                     "ground_fusion2_tpu/calib/intrinsics.py:106"),
})
LINE_KERNELS = ("line_detect", "line_refit")
DIST_KERNELS = ("dist_schur", "map_schur")
# the JAX package's line path on phase 3's 32 frames (tests/
# torch_lines_reference.py, CPU): valid segments a frame, tracked a pair
JAX_LINES = dict(
    valid=[39, 39, 39, 39, 39, 39, 39, 39, 38, 33, 29, 35, 43, 36, 40, 44,
           39, 42, 34, 30, 38, 32, 44, 39, 48, 43, 47, 49, 47, 42, 47, 41],
    tracked=[39, 39, 39, 39, 39, 39, 39, 39, 38, 33, 29, 30, 33, 25, 29, 36,
             28, 29, 25, 25, 31, 29, 41, 32, 35, 36, 39, 38, 33, 31, 35])
LINE_COUNT_TOL = 0.02  # the totals against JAX's (KLT rounds otherwise on the card)
DIST_F = 150
DIST_ITERS = 8         # tests/test_dist_ba.py's solver
DIST_MAX_D = 0.02      # m, distributed vs solve_window (test_dist_ba.py)
DIST_STAY = 1e-4       # m, warm-started from solve_window's result
MAP_K, MAP_LPK, MAP_HALO, MAP_ITERS = 64, 128, 3, 6
MAP_MAX_ERR = 0.01     # m, tests/test_dist_mapping.py:33
MAP_MAX_COST = 1e-4    # tests/test_dist_mapping.py:34
# the JAX package on phase 16's mapping problem, 6 iterations, one CPU
# device (tests/torch_parallel_reference.py)
JAX_MAP = dict(max_pose_err=0.008773226290941238, cost=3.3809077759627826e-10)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def sync_site(counter):
    """A ``warnings.showwarning`` that counts each synchronizing CUDA call
    by the innermost line of the port that made it."""
    def show(message, *args, **kwargs):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()
                  if "ground_fusion2_tpu_torch" in f.filename]
        where = (f"{frames[-1].filename.split('ground_fusion2_tpu_torch/')[-1]}"
                 f":{frames[-1].lineno}" if frames else "?")
        counter[where] += 1
    return show


# kernels D, E, F, C, W, X, L (with P's rows), AC, S and K by their
# __global__ names (csrc/lio_assoc.cu, ct_icp_normal.cu, radix_sort.cu,
# proj_normal.cu, chol_solve.cu, sym_eig.cu, small_normal.cu,
# mesh_delaunay.cu, window_cost.cu, ransac_f.cu): phases 8, 10 and 14 print
# their device ms a tick
KERNEL_GROUPS = {
    "D": ("lio_assoc_kernel",),
    "E": ("ct_icp_normal_kernel",),
    "F": ("radix_kernel",),
    "C": ("proj_feature_kernel", "proj_reduce_kernel"),
    "W": ("chol_cluster_kernel", "chol_coop_kernel", "chol_back_kernel"),
    "X": ("tridiag_kernel", "dc_kernel", "back_kernel"),
    "L": ("small_rows_kernel", "small_reduce_kernel"),
    "AC": ("mesh_delaunay_kernel",),
    "S": ("window_cost_kernel",),
    "K": ("ransac_kernel",),
    "AH": ("track_lift_kernel", "track_kill_kernel", "track_tail_kernel"),
    "AI": ("carry_write_kernel", "carry_slide_kernel"),
    "AJ": ("marg_gather_kernel", "marg_factors_kernel", "marg_scale_kernel",
           "marg_schur_kernel", "marg_prior_kernel"),
    "AK": ("ct_points_kernel", "ct_weights_kernel", "ct_step_kernel"),
    "AL": ("kp_codes_kernel", "kp_first_kernel", "kp_take_kernel",
           "ins_key_kernel", "permute_kernel", "dedup_kernel", "drop_kernel",
           "rc_key_kernel", "ev_key_kernel"),
    "AM": ("lio_update_kernel",),
    "AN": ("lm_pack_kernel", "lm_step_kernel", "lm_retract_kernel",
           "lm_weigh_kernel"),
    "AO": ("tick_unpack_kernel", "tick_track_kernel", "tick_pre_kernel",
           "tick_post_kernel"),
    "AQ": ("draw_kernel", "split_kernel"),
    "G": ("eskf_predict_kernel",),
    "U": ("window_tests_kernel",),
    "T": ("triangulate_kernel",),
    "V": ("window_update_kernel",),
    "H": ("preint_kernel",),
    "Y": ("sqrt_info_reg_kernel", "icp_solve_kernel", "degeneracy_kernel"),
    # Y's square-root informations alone, under either kernel name: the
    # register form's, and the shared-memory one an older tree launches
    # (tools/tick_split.py runs such a parent beside this tree)
    "Y sqrt_info": ("sqrt_info_reg_kernel", "sqrt_info_kernel")}
# phase 8's per-kernel line of the camera tick
CAMERA_SPLIT_GROUPS = ("AH", "AI", "AJ", "U", "Y sqrt_info", "H", "S", "AN",
                       "T", "V")
# the camera tick's profiler ranges (vio/fused.py, vio/problem.py)
CAMERA_RANGES = ("_tracker_step", "_solve_tick", "solve_window",
                 "tick_glue", "marginalize", "marginalize_oldest",
                 "marginalize_second_newest", "slide")
# the LiDAR tick's profiler ranges (lio/odometry.py, lio/fused.py)
LIDAR_RANGES = ("lidar_tick", "select_keypoints", "ct_icp", "observe_switch",
                "record", "map_update")
# cuBLAS's product kernels (and the cuBLASLt ones it picks on Hopper)
CUBLAS_KERNEL_WORDS = ("gemm", "gemv", "nvjet", "cublas", "xmma", "cutlass",
                       "splitkreduce", "dot_kernel")
# every profiler range a camera tick opens (vio/fused.py, vio/problem.py)
CAMERA_TICK_RANGES = CAMERA_RANGES + ("upload", "_solve_tick.write",
                                      "add_frame", "preintegrate",
                                      "_detectors", "triangulate",
                                      "post_solve_tests")
LINALG_KERNEL_WORDS = ("syevj", "syevd", "potrf", "potrs", "trsm", "trsv",
                       "cusolver", "lapack", "sytrd", "stedc", "steqr",
                       "ormtr", "geqrf", "getrf", "larf")


ANON = "(anonymous namespace)::"


def kernel_qualname(name: str) -> str:
    """A device kernel's qualified name without its return type, template
    arguments and parameters, from the demangled name the profiler reports:
    ``(anonymous namespace)::row_kernel``, ``at::native::reduce_kernel``."""
    import re
    s = re.sub(r"^void\s+", "", name.strip())
    return re.match(r"(?:\(anonymous namespace\)::)?[\w:]*", s).group(0)


def port_kernel_names() -> set:
    """The qualified names of the ``__global__`` functions of csrc/*.cu
    (every one sits in the file's anonymous namespace)."""
    import pathlib
    import re
    names = set()
    for src in pathlib.Path(PKG).glob("*.cu"):
        names.update(ANON + n for n in re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)",
            src.read_text()))
    return names


def device_split(prof, n_ticks: int) -> dict:
    """Device time a tick from a torch.profiler trace, in three classes (the
    port's kernels, whose qualified names are exactly those of csrc/*.cu's
    ``__global__`` functions; torch.linalg's cuSOLVER and triangular-solve
    kernels; every other kernel), the kernel launches a tick and the device
    time and launches a tick of each port kernel seen, and each group of
    ``KERNEL_GROUPS`` summed (``by_kernel_ms_per_tick``)."""
    import torch
    ours = port_kernel_names()
    from ground_fusion2_tpu_torch.utils.profiling import STAGE_PREFIX
    # the profiler's own spans of the ranges on the device's timeline
    # (gpu_user_annotation) are not activities
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset", STAGE_PREFIX))]
    ms = dict(port=0.0, linalg=0.0, other=0.0)
    seen, count = collections.Counter(), collections.Counter()
    for e in kernels:
        qual = kernel_qualname(e.name)
        cls = ("port" if qual in ours else
               "linalg" if any(w in e.name.lower() for w in LINALG_KERNEL_WORDS)
               else "other")
        if cls == "port":
            seen[qual[len(ANON):]] += e.time_range.elapsed_us() / 1e3
            count[qual[len(ANON):]] += 1
        ms[cls] += e.time_range.elapsed_us() / 1e3
    per = {k: v / n_ticks for k, v in sorted(seen.items())}
    return dict(device_ms_per_tick={k: v / n_ticks for k, v in ms.items()},
                **split_by_range(prof, n_ticks),
                launches_per_tick=len(kernels) / n_ticks,
                port_kernel_ms_per_tick=per,
                port_kernel_launches_per_tick={
                    k: v / n_ticks for k, v in sorted(count.items())},
                by_kernel_ms_per_tick={
                    k: sum(per.get(n, 0.0) for n in names)
                    for k, names in KERNEL_GROUPS.items()})


# the CUDA API calls a trace records on the host ("cuda...", "cu..."): each
# shares its correlation id with what it launched
RUNTIME_PREFIX = "cu"


def split_by_range(prof, n_ticks: int) -> dict:
    """Device ms and activities a tick by profiler range: each CUDA
    activity goes to the innermost ``gf2::`` range (``utils/profiling.py
    stage``, named after the JAX function the stretch ports) that was open
    when the host launched it (the runtime call with the same correlation
    id), "(outside)" where none was. Per range: kernel ms and launches, the
    port's kernels' share of both, and the copies and memsets."""
    import torch
    from ground_fusion2_tpu_torch.utils.profiling import STAGE_PREFIX
    ours = port_kernel_names()
    cpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU]
    ranges = sorted(((e.time_range.start, e.time_range.end,
                      e.name[len(STAGE_PREFIX):]) for e in cpu
                     if e.name.startswith(STAGE_PREFIX)), key=lambda r: r[0])
    launched = {e.id: e.time_range.start for e in cpu
                if e.name.startswith(RUNTIME_PREFIX)}
    out = collections.defaultdict(lambda: dict(
        ms=0.0, launches=0, port_ms=0.0, port_launches=0, copies=0,
        copy_ms=0.0))
    foreign = collections.defaultdict(collections.Counter)
    unmatched = 0
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.name.startswith(STAGE_PREFIX)):
            continue
        t = launched.get(e.id)
        name = "(outside)"
        if t is None:
            unmatched += 1
        else:
            inner = [r for r in ranges if r[0] <= t <= r[1]]
            if inner:
                name = max(inner, key=lambda r: r[0])[2]
        r = out[name]
        us = e.time_range.elapsed_us() / 1e3
        if e.name.startswith(("Memcpy", "Memset")):
            r["copies"] += 1
            r["copy_ms"] += us
            continue
        r["ms"] += us
        r["launches"] += 1
        if kernel_qualname(e.name) in ours:
            r["port_ms"] += us
            r["port_launches"] += 1
        elif not any(w in e.name.lower() for w in CUBLAS_KERNEL_WORDS):
            # torch's copy kernels count: the one kernel both copies and
            # converts dtypes, and its name does not say which
            if "copy_kernel" in e.name:
                r["copy_kernels"] = r.get("copy_kernels", 0) + 1
            foreign[name][kernel_qualname(e.name)[:80]] += 1
    per = {k: {f: round(v / n_ticks, 5) for f, v in r.items()}
           for k, r in sorted(out.items(), key=lambda kv: -kv[1]["ms"])}
    return dict(by_range=per, unmatched_activities=unmatched,
                foreign_by_range={k: {n: c / n_ticks for n, c in v.items()}
                                  for k, v in sorted(foreign.items())})


def camera_foreign(split: dict) -> dict:
    """The CUDA kernels a camera tick launches (in its profiler ranges)
    that are neither the port's nor cuBLAS's products, torch's copy kernels
    (copies and dtype conversions alike) included, by name: launches a tick
    (the memcpy and memset activities are not kernels)."""
    got = collections.Counter()
    for rng in CAMERA_TICK_RANGES:
        got.update(split.get("foreign_by_range", {}).get(rng, {}))
    return dict(got)


def start_profiler():
    """A torch.profiler trace of CPU and CUDA activity, entered."""
    import torch
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def lio_rc_thresh(lo) -> float:
    """The recenter threshold of the odometry ``lo``'s tick."""
    from ground_fusion2_tpu_torch.lio import voxel_map as vm
    st = lo._statics
    return st.recenter_margin * (vm.HALF * st.map_cfg.voxel_size)


def lidar_main_path(dev, card):
    """Phase 5. Returns (error or None, launches during the drive, the
    odometry, the scan after the drive)."""
    import torch
    from ground_fusion2_tpu_torch import _kernels, checks
    from ground_fusion2_tpu_torch.config import m3dgr_lio
    from ground_fusion2_tpu_torch.lio.odometry import LidarOdometry
    from ground_fusion2_tpu_torch.lio.voxel_map import INVALID

    scans = checks.lidar_drive(LIO_SCANS + 1, z=LIO_Z)
    lo = LidarOdometry(m3dgr_lio(), device=dev)
    tick_ms, outs, gt, syncs_seen = [], [], [], []
    prof = None          # the last 3 ticks' device trace
    _kernels.launches.clear()
    for k, s in enumerate(scans[:LIO_SCANS]):
        fused = lo.initialized
        # the last 3 ticks also count every synchronizing CUDA call, and
        # are traced
        watch = fused and k >= LIO_SCANS - 3
        if watch and prof is None:
            prof = start_profiler()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            if watch:
                torch.cuda.set_sync_debug_mode("warn")
            out = lo.process_scan(s["t"], s["pts"], s["alpha"], s["valid"],
                                  s["imu"])
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        if fused:
            tick_ms.append((time.perf_counter() - t1) * 1e3)
        if watch:
            syncs_seen.append(sum("synchronizing" in str(w.message)
                                  for w in seen))
        if out is not None:
            if not (np.all(np.isfinite(out.p_lio))
                    and np.all(np.isfinite(out.q_lio))):
                return f"non-finite LIO pose at t={s['t']:.2f}", {}, lo, None
            outs.append(out)
            gt.append(s["p_gt"])
    if prof is not None:
        prof.__exit__(None, None, None)
    launches = dict(_kernels.launches)
    n_fused = len(tick_ms)
    if not lo.initialized or not outs:
        return "the LIO never initialized", launches, lo, None
    if n_fused < 50:
        return f"only {n_fused} fused LIO ticks ran", launches, lo, None
    st = lo.eskf
    if not all(bool(torch.isfinite(t).all()) for t in st):
        return "non-finite ESKF state", launches, lo, None
    if min(launches.get(k, 0) for k in LIO_PATH_KERNELS) <= 0:
        return f"a LiDAR kernel did not launch: {launches}", launches, lo, None
    if any(launches.get(k, 0) for k in LIO_OFF_PATH):
        return (f"a kernel off the LiDAR path launched ({LIO_OFF_PATH}): "
                f"{launches}", launches, lo, None)
    if prof is not None:
        fig = lidar_split_line("phase 5, the LiDAR tick alone",
                               device_split(prof, len(syncs_seen)), card)
        ak = fig["kernel_launches_per_tick"]["AK"]
        if ak != LIO_AK_PER_TICK:
            return (f"kernel AK launched {ak:g} times a LiDAR tick: CT-ICP's "
                    "glue runs in kernels D and E, AK only transforms the "
                    "scan", launches, lo, None)
    off = gt[0] - outs[0].p_lio
    errs = [float(np.linalg.norm(o.p_lio + off - g)) for o, g in zip(outs, gt)]
    deg = [i for i, o in enumerate(outs) if o.degenerate and i >= 2]
    fill = int((lo.vmap.code != INVALID).sum())
    print(f"lidar path: {n_fused} fused ticks, median tick "
          f"{float(np.median(tick_ms[2:])):.2f} ms (synchronized wall, ticks "
          f"3..{n_fused}), host syncs (synchronizing CUDA calls) in each "
          f"of the last 3 ticks {syncs_seen}, max position error "
          f"{max(errs):.4f} m (final {errs[-1]:.4f} m) over {len(outs)} "
          f"outputs, map fill {fill} of "
          f"{lo.cfg.map_cfg.capacity}, degenerate after the second: {deg}, "
          f"launches {launches} | {card}", flush=True)
    if deg:
        return f"degenerate LIO scans after the second: {deg}", launches, lo, None
    if max(syncs_seen) > 1:
        return (f"host syncs a LiDAR tick {syncs_seen}: more than the record "
                "read", launches, lo, None)
    if not max(errs) < LIO_MAX_ERR:
        return (f"LIO position error {max(errs):.4f} m >= {LIO_MAX_ERR} m",
                launches, lo, None)
    return None, launches, lo, scans[LIO_SCANS]


def lidar_split_line(what: str, split: dict, card: str,
                     ranges: bool = False) -> dict:
    """Prints the LiDAR tick's launches and device ms a tick, with the
    LiDAR kernels' launches and device ms a tick (KERNEL_GROUPS D-G, Y,
    AK-AM), from a ``device_split`` over whole LiDAR ticks or (``ranges``)
    over LIDAR_RANGES of system ticks; returns the figures."""
    if ranges:
        lr = [split["by_range"].get(k, {}) for k in LIDAR_RANGES]
        launches = sum(v.get("launches", 0) for v in lr)
        ms = sum(v.get("ms", 0.0) for v in lr)
    else:
        launches = split["launches_per_tick"]
        ms = sum(split["device_ms_per_tick"].values())
    per = split["port_kernel_launches_per_tick"]
    groups = ("G", "D", "E", "Y", "F", "AK", "AL", "AM")
    fig = dict(launches_per_tick=launches, device_ms_per_tick=ms,
               kernel_launches_per_tick={
                   g: sum(per.get(n, 0) for n in KERNEL_GROUPS[g])
                   for g in groups},
               kernel_device_ms_per_tick={
                   g: round(split["by_kernel_ms_per_tick"][g], 5)
                   for g in groups})
    print(f"LiDAR tick split ({what}; torch.profiler over the last 3 ticks, "
          f"printed only): {launches:g} kernel launches and {ms:.4f} device "
          f"ms a tick; by kernel, launches "
          + json.dumps(fig["kernel_launches_per_tick"]) + " and device ms "
          + json.dumps(fig["kernel_device_ms_per_tick"]) + f" a tick | {card}",
          flush=True)
    return fig


class CallCounter:
    """Counts the calls of ``module.name`` while installed (a context) and
    keeps the positional arguments of the last 8."""

    def __init__(self, module, name):
        self.module, self.name, self.n = module, name, 0
        self.recent = collections.deque(maxlen=8)

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def wrapper(*a, **k):
            self.n += 1
            self.recent.append(a)
            return self.orig(*a, **k)
        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


LINALG_NOT_COUNTED = ("norm", "vector_norm", "matrix_norm", "cross")
# torch's own factorization, solve and inverse entry points outside
# torch.linalg (those this torch has are counted)
TORCH_LINALG = ("cholesky", "cholesky_solve", "cholesky_inverse", "inverse",
                "det", "logdet", "slogdet", "svd", "pinverse", "lu",
                "lu_solve", "lu_unpack", "geqrf", "ormqr", "triangular_solve",
                "lstsq")


class LinalgCounter:
    """Counts the calls of every torch.linalg function but the norms and
    cross (LINALG_NOT_COUNTED), and of TORCH_LINALG, while installed."""

    def __enter__(self):
        import torch
        self.counters = [
            CallCounter(torch.linalg, n) for n in dir(torch.linalg)
            if not n.startswith("_") and n not in LINALG_NOT_COUNTED
            and callable(getattr(torch.linalg, n))
            and not isinstance(getattr(torch.linalg, n), type)]
        self.counters += [CallCounter(torch, n) for n in TORCH_LINALG
                          if hasattr(torch, n)]
        for c in self.counters:
            c.__enter__()
        return self

    def __exit__(self, *exc):
        for c in self.counters:
            c.__exit__(*exc)

    @property
    def calls(self) -> dict:
        return {c.name: c.n for c in self.counters if c.n}


class AssocSearches:
    """While installed, keeps kernel D's ``search`` argument of every
    ``voxel_map.associate`` call (True, False, or CT-ICP's device flag, by
    reference: no launch); :meth:`searched`, read once the drive is over,
    counts the calls that searched the map."""

    def __enter__(self):
        from ground_fusion2_tpu_torch.lio import voxel_map as vm
        self.vm, self.own, self.calls = vm, vm.associate, []

        def associate(vmap, p_gather, p_query, cfg, ranges=None, search=True):
            self.calls.append(search)
            return self.own(vmap, p_gather, p_query, cfg, ranges, search)
        vm.associate = associate
        return self

    def __exit__(self, *exc):
        self.vm.associate = self.own

    def searched(self) -> int:
        return sum(bool(s) for s in self.calls)


def prior_finite(fv) -> bool:
    """Whether FusedVio ``fv``'s marginalization prior is finite (kernel X
    gives NaN where it does not converge, and the NaN stays in every later
    prior)."""
    import torch
    pr = fv.carry.prior
    return bool(torch.isfinite(pr.sqrt_J).all() and torch.isfinite(pr.r0).all())


def linalg_free(phase: str, fn, *args):
    """``fn(*args)`` with the torch.linalg counter installed; prints the
    count. Returns (fn's result, error or None): an error when any counted
    call ran."""
    with LinalgCounter() as lc:
        out = fn(*args)
    print(f"phase {phase}: torch.linalg factorization/solve/eigensolver calls "
          f"{lc.calls or 0}", flush=True)
    return out, (f"phase {phase} called torch.linalg {lc.calls}"
                 if lc.calls else None)


def camera_main_path(dev, card, frames, cam=None):
    """Phase 4 (and phase 17's drive with ``cam`` in place of the M3DGR
    pinhole). Returns (error or None, the FusedVio, launches, the run: its
    ATE and each fused tick's window state on the host)."""
    import torch
    from ground_fusion2_tpu_torch import _kernels, checks
    from ground_fusion2_tpu_torch.config import m3dgr_camera
    from ground_fusion2_tpu_torch.core.cameras import Pinhole
    from ground_fusion2_tpu_torch.eval import metrics
    from ground_fusion2_tpu_torch.factors import vio_factors as fac
    from ground_fusion2_tpu_torch.vio.fused import FusedVio

    from ground_fusion2_tpu_torch.vio.state import NUM_FRAMES

    cfg = m3dgr_camera()
    fv = FusedVio(cfg.estimator, cfg.tracker,
                  cam or Pinhole.create(*cfg.intrinsics),
                  dev, tic=np.zeros(3), ric=checks.RIG_RIC,
                  tio=np.zeros(3), rio=np.eye(3), depth_stride=2)
    # the record's read is the tick's output reaching the host: the sync
    # watch stops there
    emit = fv._emit

    def emit_unwatched(*a, **k):
        torch.cuda.set_sync_debug_mode("default")
        return emit(*a, **k)
    fv._emit = emit_unwatched
    _kernels.launches.clear()
    tick_ms, est, gt, windows = [], [], [], []
    full_syncs, sites_seen = [], collections.Counter()
    branches = collections.Counter()
    launches_at_fused = None
    with CallCounter(torch.func, "jacfwd") as jac, \
            CallCounter(fac, "window_cost_plain") as plain_cost:
        for f in frames:
            fused = fv.carry is not None
            full = fused and fv.frame_count >= NUM_FRAMES
            if fused and launches_at_fused is None:
                launches_at_fused = dict(_kernels.launches)
                at_fused = (jac.n, plain_cost.n)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            tick_sites = collections.Counter()
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = sync_site(tick_sites)
                if full:
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = fv.process_image(f["t"], f["gray"], f["depth"],
                                           f["imu"], wheel_vel=f["wheel"])
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            if full:
                full_syncs.append(sum(tick_sites.values()))
                sites_seen.update(tick_sites)
                branches["MARGIN_OLD" if out.is_keyframe
                         else "MARGIN_SECOND_NEW"] += 1
            if fused:
                tick_ms.append((time.perf_counter() - t1) * 1e3)
                st = fv.carry.state
                windows.append(torch.cat([st.p.reshape(-1), st.q.reshape(-1),
                                          st.v.reshape(-1), st.rho]).cpu())
            if out.initialized:
                if not np.all(np.isfinite(out.p)) or not np.all(np.isfinite(out.q)):
                    return f"non-finite state at t={f['t']:.2f}", fv, {}, None
                est.append(out.p)
                gt.append(f["p_gt"])
    launches = dict(_kernels.launches)
    n_fused = len(tick_ms)
    if not fv.initialized or not est:
        return "the estimator never initialized", fv, launches, None
    if n_fused < 20:
        return f"only {n_fused} fused ticks ran", fv, launches, None
    st = fv.carry.state
    if not all(bool(torch.isfinite(t).all()) for t in (st.p, st.q, st.v, st.rho)):
        return "non-finite window state", fv, launches, None
    if not prior_finite(fv):
        return "non-finite marginalization prior", fv, launches, None
    grew = {k: launches.get(k, 0) - (launches_at_fused or {}).get(k, 0)
            for k in CAMERA_KERNELS + CAMERA_OFF_PATH}
    off = {k: grew.pop(k) for k in CAMERA_OFF_PATH}
    if min(grew.values()) <= 0:
        return (f"a kernel did not launch during the fused ticks: {grew}", fv,
                launches, None)
    if any(off.values()):
        return (f"a standalone launch the camera tick folds launched during "
                f"the fused ticks: {off}", fv, launches, None)
    jac_fused, cost_fused = (
        n - n0 for n, n0 in zip((jac.n, plain_cost.n), at_fused))
    ate = float(metrics.ate_rmse(np.asarray(est), np.asarray(gt), align=True))
    print(f"camera path: {n_fused} fused ticks, median tick "
          f"{float(np.median(tick_ms[2:])):.2f} ms (synchronized wall, ticks "
          f"3..{n_fused}), synchronizing calls on each of the "
          f"{len(full_syncs)} ticks with the window full {full_syncs} (by "
          f"call site {dict(sites_seen.most_common())}), their slides "
          f"{dict(branches)}, ATE {ate:.6f} m aligned over {len(est)} frames, "
          f"during the fused ticks: torch.func.jacfwd calls {jac_fused}, "
          f"plain window-cost calls {cost_fused}; launches {launches}, during "
          f"fused ticks "
          f"{grew} | {card}", flush=True)
    if any(full_syncs):
        return (f"synchronizing calls on a camera tick with the window full: "
                f"{full_syncs} ({dict(sites_seen.most_common())})", fv,
                launches, None)
    if min(branches["MARGIN_OLD"], branches["MARGIN_SECOND_NEW"]) < 1:
        return (f"the full ticks took one slide only: {dict(branches)}", fv,
                launches, None)
    if jac_fused:
        return (f"torch.func.jacfwd ran {jac_fused} times on the card", fv,
                launches, None)
    if cost_fused:
        return (f"the plain window cost ran {cost_fused} times on the card",
                fv, launches, None)
    if not ate < 0.30:
        return f"ATE {ate:.3f} m >= 0.30 m", fv, launches, None
    return None, fv, launches, dict(ate=ate, windows=windows)


def system_main_path(dev, card, frames):
    """Phase 8 over ``frames`` (checks.system_drive). Returns (error or
    None, launches during the drive, the median system tick in ms, the
    GroundFusion)."""
    import torch
    from ground_fusion2_tpu_torch import _kernels, checks
    from ground_fusion2_tpu_torch.config import m3dgr_system
    from ground_fusion2_tpu_torch.system import GroundFusion

    gf = GroundFusion(m3dgr_system(), tic=np.zeros(3), ric=checks.RIG_RIC,
                      tio=np.zeros(3), rio=np.eye(3), device=dev)
    vio, tick_ms, syncs_seen = [], [], []
    sites = collections.Counter()      # of the last tick
    launches_at_live = None
    prof = None          # the last 3 ticks' device trace
    _kernels.launches.clear()
    searches = AssocSearches().__enter__()
    for k, f in enumerate(frames):
        live = gf.vio.carry is not None and gf.lio.carry is not None
        if live and launches_at_live is None:
            launches_at_live = dict(_kernels.launches)
        watch = live and k >= SYS_FRAMES - 3
        if watch and prof is None:
            prof = start_profiler()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tick_sites = collections.Counter()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = sync_site(tick_sites)
            if watch:
                torch.cuda.set_sync_debug_mode("warn")
            out = gf.process_camera_image(f["t"], f["gray"], f["depth"],
                                          f["imu"], wheel_vel=f["wheel"])
            gf.process_lidar(f["t"], f["pts"], f["alpha"], f["valid"],
                             f["imu"])
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        if live:
            tick_ms.append((time.perf_counter() - t1) * 1e3)
        if watch:
            syncs_seen.append(sum(tick_sites.values()))
            sites = tick_sites
        if out is not None and out.initialized:
            vio.append(out)
    if prof is not None:
        prof.__exit__(None, None, None)
    out = gf.flush()
    searches.__exit__()
    if out is not None and out.initialized:
        vio.append(out)
    launches = dict(_kernels.launches)
    n_live = len(tick_ms)
    if not (gf.vio.initialized and gf.lio.initialized) or not vio:
        return "an estimator never initialized", launches, None, gf
    if n_live < 20:
        return (f"only {n_live} system ticks ran with both carries live",
                launches, None, gf)
    grew = {k: launches.get(k, 0) - (launches_at_live or {}).get(k, 0)
            for k in CAMERA_KERNELS + LIDAR_KERNELS + CAMERA_OFF_PATH}
    off = {k: grew.pop(k) for k in CAMERA_OFF_PATH}
    if min(grew.values()) <= 0:
        return (f"a kernel did not launch during the system ticks: {grew}",
                launches, None, gf)
    if any(off.values()):
        return (f"a standalone launch the camera tick folds launched during "
                f"the system ticks: {off}", launches, None, gf)
    if not all(np.all(np.isfinite(o.p)) and np.all(np.isfinite(o.q))
               for o in gf.trajectory):
        return "a non-finite fused pose", launches, None, gf
    if not prior_finite(gf.vio):
        return "non-finite marginalization prior", launches, None, gf
    r = checks.system_errors(gf.trajectory, vio, frames)
    split = device_split(prof, len(syncs_seen)) if prof is not None else {}
    print("system tick split over the last 3 ticks (torch.profiler, CUDA "
          f"activities; printed only): {json.dumps(split)}, host wall a tick "
          f"{[round(t, 2) for t in tick_ms[-len(syncs_seen):]]} ms (profiled "
          f"and sync-watched), synchronizing calls a tick {syncs_seen} by "
          f"call site of the last {dict(sites.most_common())}, median of the "
          f"unprofiled ticks {float(np.median(tick_ms[2:-3])):.2f} ms | {card}",
          flush=True)
    if split:
        rows = {k: (round(v["ms"], 4), v["launches"], round(v["port_ms"], 4))
                for k, v in split["by_range"].items()}
        print(f"system tick by profiler range over the last 3 ticks (device "
              f"ms, kernel launches, of which the port's kernels' ms, a "
              f"tick; printed only): {json.dumps(rows)}; kernels AH, AI, AJ, "
              f"U, Y's square-root informations, H, S, AN launches a tick "
              + json.dumps({g: sum(split['port_kernel_launches_per_tick']
                                   .get(n, 0) for n in KERNEL_GROUPS[g])
                            for g in CAMERA_SPLIT_GROUPS})
              + f", device ms a tick "
              + json.dumps({g: round(split["by_kernel_ms_per_tick"][g], 5)
                            for g in CAMERA_SPLIT_GROUPS}) + f" | {card}",
              flush=True)
        lr = {k: split["by_range"].get(k, dict(ms=0.0, launches=0,
                                                  port_ms=0.0, copies=0))
              for k in LIDAR_RANGES}
        print("the LiDAR tick by profiler range over the last 3 ticks (device "
              "ms, kernel launches, of which the port's kernels' ms, copies, "
              "a tick; printed only): "
              + json.dumps({k: (round(v["ms"], 4), v["launches"],
                                round(v["port_ms"], 4), v["copies"])
                            for k, v in lr.items()})
              + f"; in all {sum(v['ms'] for v in lr.values()):.4f} ms in "
              f"{sum(v['launches'] for v in lr.values()):g} launches; kernels "
              "AK, AL, AM launches a tick "
              + json.dumps({g: sum(split['port_kernel_launches_per_tick']
                                   .get(n, 0) for n in KERNEL_GROUPS[g])
                            for g in ("AK", "AL", "AM")})
              + ", device ms a tick "
              + json.dumps({g: round(split["by_kernel_ms_per_tick"][g], 5)
                            for g in ("AK", "AL", "AM")}) + f" | {card}",
              flush=True)
        lidar_split_line("phase 8, the LiDAR ranges of the system tick",
                         split, card, ranges=True)
        cr = {k: split["by_range"].get(k, dict(ms=0.0, launches=0,
                                                 port_ms=0.0, copies=0))
              for k in CAMERA_RANGES}
        kf = [bool(o.is_keyframe) for o in vio[-len(syncs_seen):]]
        print("the camera tick by profiler range over the last 3 ticks "
              "(device ms, kernel launches, of which the port's kernels' ms, "
              "copies, a tick; printed only): "
              + json.dumps({k: (round(v["ms"], 4), v["launches"],
                                round(v["port_ms"], 4), v["copies"])
                            for k, v in cr.items()})
              + f"; their keyframe flags {kf} (MARGIN_OLD where set, both "
              "marginalizations launched on every full tick, the skipped "
              "one's kernels leaving at once); kernels AN, AO launches a tick "
              + json.dumps({g: sum(split['port_kernel_launches_per_tick']
                                   .get(n, 0) for n in KERNEL_GROUPS[g])
                            for g in ("AN", "AO", "AQ")})
              + ", device ms a tick "
              + json.dumps({g: round(split["by_kernel_ms_per_tick"][g], 5)
                            for g in ("AN", "AO", "AQ")}) + f" | {card}",
              flush=True)
        fc = camera_foreign(split)
        copies = sum(split["by_range"].get(k, {}).get("copy_kernels", 0)
                     for k in CAMERA_TICK_RANGES)
        print("the camera tick's kernels that are neither the port's nor "
              "cuBLAS products, launches a tick over the last 3 ticks: "
              f"{sum(fc.values()):g} {json.dumps(fc)} (of which torch's copy "
              f"kernels, copies and conversions alike, {copies:g}; memcpy / "
              f"memset activities aside) | {card}", flush=True)
        per_tick = split["port_kernel_launches_per_tick"]
        print(f"kernels D and E in the system tick: launches a LiDAR tick "
              f"D {per_tick.get('lio_assoc_kernel', 0):g}, E "
              f"{per_tick.get('ct_icp_normal_kernel', 0):g} (torch.profiler, "
              f"the last 3 ticks), device ms a tick D "
              f"{split['by_kernel_ms_per_tick']['D']:.4f}, E "
              f"{split['by_kernel_ms_per_tick']['E']:.4f}; D's calls that "
              f"searched the map {searches.searched()} of "
              f"{len(searches.calls)} over the drive (the rest ranked the "
              f"solve's cached candidates) | {card}", flush=True)
    print(f"system path: {n_live} system ticks with both carries live, "
          f"median system tick {float(np.median(tick_ms[2:])):.2f} ms "
          f"(synchronized wall, ticks 3..{n_live}), host syncs "
          f"(synchronizing CUDA calls) in each of the last 3 ticks "
          f"{syncs_seen} (the last by call site: {dict(sites.most_common())}), "
          f"switches {len(r['switches'])} {r['switches']}, "
          f"fused position error {r['fused_err']:.4f} m max (final "
          f"{r['fused_err_final']:.4f} m) over {r['n_fused']} outputs, VIO "
          f"ATE {r['vio_ate']:.4f} m aligned over {r['n_vio']} outputs, "
          f"degenerate after the second: {r['degenerate']}, launches "
          f"{launches}, during the live ticks {grew} | {card}", flush=True)
    median = float(np.median(tick_ms[2:]))
    if r["degenerate"]:
        return (f"degenerate scans after the second: {r['degenerate']}",
                launches, median, gf)
    if not r["fused_err"] < SYS_MAX_ERR:
        return (f"fused position error {r['fused_err']:.4f} m >= "
                f"{SYS_MAX_ERR} m"), launches, median, gf
    if not r["vio_ate"] < SYS_MAX_ATE:
        return (f"VIO ATE {r['vio_ate']:.4f} m >= {SYS_MAX_ATE} m", launches,
                median, gf)
    if split and camera_foreign(split):
        return (f"the camera tick launched kernels that are neither the "
                f"port's nor cuBLAS products: {camera_foreign(split)}",
                launches, median, gf)
    if split and split["device_ms_per_tick"]["linalg"] > 0:
        return (f"cuSOLVER / triangular-solve kernels ran in the system tick: "
                f"{split['device_ms_per_tick']['linalg']:.4f} ms a tick",
                launches, median, gf)
    return None, launches, median, gf


def glue_checks(dev, frames, gf, frame) -> dict:
    """Phase 8b: kernels AH (on ``frames`` 12 → 13, phase 4's), AI, AJ, AN
    and AO (on ``gf``'s final fused window, phase 8's, and ``frame``'s IMU
    chunk) against their plain routes on the card; the slide chosen on the
    device against the host's choice in both branches, and every predicated
    kernel off its branch leaving its outputs untouched; H with Y's
    square-root informations and S with AN's step against H then Y and S
    then AN (``checks.check_preint_lm_fold``)."""
    from ground_fusion2_tpu_torch import checks
    fv = gf.vio
    out = {"track_tail": checks.check_track_tail(
               dev, frames[12:14], fv.cam,
               (fv.tcfg.depth_range[0], fv.tcfg.depth_range[1])),
           "window_carry": checks.check_window_carry(dev, fv, frame),
           "marg_schur": checks.check_marg_schur(dev, fv),
           "lm_glue": checks.check_lm_glue(dev, fv),
           "tick_glue": checks.check_tick_glue(dev, fv),
           "device_slide": checks.check_device_slide(dev, fv),
           "preint_lm_fold": checks.check_preint_lm_fold(dev, fv)}
    return out


def loop_main_path(dev, card):
    """Phase 9. Returns (error or None, launches during the drive, the
    GroundFusion, the drive)."""
    import torch
    from ground_fusion2_tpu_torch import _kernels, checks
    from ground_fusion2_tpu_torch.config import PoseGraphConfig, m3dgr_camera
    from ground_fusion2_tpu_torch.system import GroundFusion, SystemConfig

    t0 = time.perf_counter()
    drive = checks.loop_drive(LOOP_KEYFRAMES)
    print(f"loop drive: {LOOP_KEYFRAMES} keyframes rendered in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    pg_cfg = PoseGraphConfig(num_feats=150, ric=checks.RIG_RIC,
                             tic=np.zeros(3))
    gf = GroundFusion(SystemConfig(
        vio=m3dgr_camera().estimator, use_lidar=False, use_loop_closure=True,
        pose_graph=pg_cfg, cam_intr=checks.M3DGR_INTRINSICS),
        tic=np.zeros(3), ric=checks.RIG_RIC, device=dev)
    gf.vio = checks.ScriptedVio([(f["p_odom"], f["q_odom"]) for f in drive])
    tick_ms = []
    _kernels.launches.clear()
    for f in drive:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        gf.process_camera(f["t"], None, checks.LOOP_IMU, img=f["gray"],
                          depth_img=f["depth"])
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t1) * 1e3)
    launches = dict(_kernels.launches)
    r = checks.loop_errors(gf, drive)
    print(f"loop path: {LOOP_KEYFRAMES} keyframes, median keyframe "
          f"{float(np.median(tick_ms)):.2f} ms, max {max(tick_ms):.2f} ms "
          f"(synchronized wall, the fan-out and any optimization), loop "
          f"events {r['events']}, edges "
          f"{[(int(i), int(j)) for i, j, *_ in gf.pg.loops]}, endpoint error "
          f"published {r['err_pub']:.4f} m vs raw {r['err_raw']:.4f} m (ratio "
          f"{r['ratio']:.4f}), launches {launches} | {card}", flush=True)
    if min(launches.get(k, 0) for k in LOOP_KERNELS + ("chol_solve",)) <= 0:
        return f"a loop kernel did not launch: {launches}", launches, gf, drive
    if not r["events"]:
        return "no loop closed", launches, gf, drive
    if not r["ratio"] < LOOP_MAX_RATIO:
        return (f"published endpoint error {r['err_pub']:.4f} m >= "
                f"{LOOP_MAX_RATIO} x raw {r['err_raw']:.4f} m"), launches, gf, drive
    return None, launches, gf, drive


def gnss_main_path(dev, card):
    """Phase 10. Returns (error or None, launches during the drive, the
    GroundFusion)."""
    import torch
    from ground_fusion2_tpu_torch import _kernels, checks
    from ground_fusion2_tpu_torch.config import groundchallenge_gnss
    from ground_fusion2_tpu_torch.core.cameras import Pinhole
    from ground_fusion2_tpu_torch.system import GroundFusion, SystemConfig

    t0 = time.perf_counter()
    frames = checks.gnss_drive()
    print(f"gnss drive: {len(frames)} frames simulated in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cam = groundchallenge_gnss()
    gf = GroundFusion(SystemConfig(
        vio=cam.estimator, use_lidar=False, use_global_fusion=True,
        global_every=5, tracker=cam.tracker,
        cam=Pinhole.create(*cam.intrinsics), cam_intr=cam.intrinsics),
        tic=frames[0]["tic"], ric=frames[0]["ric"], tio=np.zeros(3),
        rio=np.eye(3), device=dev)
    # every eigensolve's eigenvalues, to count those near the 1e-6 gates
    # (on a full window both marginalizations launch, each on its branch:
    # the skipped one's solves are left out once the drive has run)
    from ground_fusion2_tpu_torch.solver import marginalize as mg
    solves, sym_eig = [], mg.sym_eig

    def recording(A, *branch):
        w, V = sym_eig(A, *branch)
        solves.append((w, branch[0] if branch else None))
        return w, V
    mg.sym_eig = recording
    _kernels.launches.clear()
    try:
        outs, tick_ms, opt_ms, enabled, align, prof = _gnss_drive(
            gf, frames, profile_last=3)
    finally:
        mg.sym_eig = sym_eig
    if isinstance(outs, str):
        return outs, {}, gf
    launches = dict(_kernels.launches)
    if prof is not None:
        split = device_split(prof, 3)
        n = split["port_kernel_launches_per_tick"]
        print(f"gnss tick split over the last 3 ticks (torch.profiler, CUDA "
              f"activities; printed only): kernels L and P "
              f"{split['by_kernel_ms_per_tick']['L']:.4f} device ms a tick in "
              f"{sum(n.get(k, 0.0) for k in KERNEL_GROUPS['L']):g} launches "
              f"a tick (by kernel {json.dumps({k: n.get(k, 0.0) for k in KERNEL_GROUPS['L']})}), "
              f"the tick {split['device_ms_per_tick']} device ms in "
              f"{split['launches_per_tick']:g} launches; by kernel "
              f"{json.dumps(split['by_kernel_ms_per_tick'])} | {card}",
              flush=True)
    eig_w = [w for w, br in solves
             if br is None or bool(br[0]) == bool(br[1])]
    near = [int(((w > 1e-7) & (w < 1e-5)).sum()) for w in eig_w]
    print(f"gnss path: {len(eig_w)} eigensolves in the marginalizations "
          f"(sizes {sorted({int(w.numel()) for w in eig_w})}), eigenvalues "
          f"within a factor 10 of the 1e-6 gates: {sum(near)} in all, at most "
          f"{max(near, default=0)} in one, on {sum(n > 0 for n in near)} "
          "solves", flush=True)
    if launches.get("chol_solve", 0) <= 0 or launches.get("sym_eig", 0) <= 0:
        return f"kernel W or X did not launch: {launches}", launches, gf
    unconverged = sum(not bool(torch.isfinite(w).all()) for w in eig_w)
    if unconverged:
        return (f"kernel X did not converge on {unconverged} of its "
                f"{len(eig_w)} eigensolves", launches, gf)
    return _gnss_gates(gf, frames, outs, tick_ms, opt_ms, enabled, align,
                       launches, card)


def _gnss_drive(gf, frames, profile_last: int = 0):
    """Phase 10's drive loop; (outs, tick_ms, opt_ms, enabled, align, the
    torch.profiler trace of the last ``profile_last`` frames or None), or
    the error message in place of outs."""
    import torch
    from ground_fusion2_tpu_torch import checks
    outs, tick_ms, opt_ms, enabled = [], [], [], []
    align, prof = None, None
    for k, f in enumerate(frames):
        if k == len(frames) - profile_last and prof is None:
            prof = start_profiler()
        fused = gf.vio.carry is not None
        n_opt = len(gf.telemetry.events)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        o = gf.process_camera(f["t"], f["obs"], f["imu"], wheel_vel=f["wheel"],
                              gnss_meas=f["gnss"], gps_enu=f["gps_enu"],
                              gps_std=checks.GNSS_FIX_STD)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        if any(ev["kind"] == "global_opt" for ev in gf.telemetry.events[n_opt:]):
            opt_ms.append(ms)
        elif fused:
            tick_ms.append(ms)
        if fused:
            enabled.append(float(gf.vio.gnss_enabled))
        if align is None and gf.vio.legacy.gnss_ready:
            align = k
        if o is not None and o.initialized and not (
                np.all(np.isfinite(o.p)) and np.all(np.isfinite(o.q))):
            if prof is not None:
                prof.__exit__(None, None, None)
            return (f"non-finite state at t={f['t']:.2f}", None, None, None,
                    None, None)
        outs.append(o)
    if prof is not None:
        prof.__exit__(None, None, None)
    return outs, tick_ms, opt_ms, enabled, align, prof


def _gnss_gates(gf, frames, outs, tick_ms, opt_ms, enabled, align, launches,
                card):
    """Phase 10's gates and print; (error or None, launches, gf)."""
    import torch
    from ground_fusion2_tpu_torch import checks
    fv = gf.vio
    if not fv.initialized:
        return "the estimator never initialized", launches, gf
    if align is None:
        return "GNSS-VI alignment never completed", launches, gf
    n_fused = len(enabled)
    if n_fused < 60:
        return f"only {n_fused} fused ticks ran", launches, gf
    if not any(e > 0 for e in enabled):
        return "gnss_enabled was 0 on every fused tick", launches, gf
    st = fv.carry.state
    if not all(bool(torch.isfinite(t).all()) for t in st):
        return "non-finite window state", launches, gf
    if not prior_finite(fv):
        return "non-finite marginalization prior", launches, gf
    if any(launches.get(k, 0) <= 0 for k in GNSS_KERNELS):
        return f"a GNSS kernel did not launch: {launches}", launches, gf
    r = checks.gnss_errors(outs, frames, gf)
    n_opt = sum(ev["kind"] == "global_opt" for ev in gf.telemetry.events)
    yaw = float(st.gyaw)
    print(f"gnss path: {n_fused} fused ticks (gnss_enabled 1 on "
          f"{int(sum(enabled))}), aligned on frame {align} (JAX "
          f"{JAX_GNSS['align_tick']}), yaw {yaw:.6f} rad (JAX "
          f"{JAX_GNSS['yaw']:.6f}), unaligned ATE {r['ate']:.6f} m after init "
          f"on frame {r['init_tick']} (JAX {JAX_GNSS['ate']:.6f}; with the "
          f"port's f64 elimination {JAX_GNSS['ate_f64']:.6f}), "
          f"{n_opt} global_opt (JAX {JAX_GNSS['global_opt']}), graph nodes "
          f"{r['global_nodes']} RMS {r['global_rms']:.6f} m max "
          f"{r['global_max']:.6f} m to the truth (JAX "
          f"{JAX_GNSS['global_rms']:.6f}; f64 elimination "
          f"{JAX_GNSS['global_rms_f64']:.6f}), median fused tick "
          f"{float(np.median(tick_ms)):.2f} ms, median tick with a global "
          f"optimize {float(np.median(opt_ms)):.2f} ms (synchronized wall), "
          f"launches {launches} | {card}", flush=True)
    off = abs(r["ate"] - JAX_GNSS["ate"])
    print(f"gnss gate against the JAX package's own ATE (its float32 "
          f"elimination): within 0.05 m: "
          + ("met" if off <= 0.05 else
             f"missed by {off - 0.05:.6f} m: JAX's figure is its own f32 "
             "eigh's rounding (ROADMAP.md queue 3, reference behaviours); "
             "the gate held is "
             "against the JAX package at float64"), flush=True)
    if n_opt < 3:
        return f"only {n_opt} global_opt events", launches, gf
    if not (r["ate"] < GNSS_MAX_ATE
            and abs(r["ate"] - JAX_GNSS["ate_f64"]) <= 0.05):
        return f"GNSS ATE {r['ate']:.4f} m off the gates", launches, gf
    if abs(yaw - checks.GNSS_YAW) >= GNSS_YAW_TOL:
        return (f"yaw {yaw:.4f} rad not within {GNSS_YAW_TOL} of "
                f"{checks.GNSS_YAW}", launches, gf)
    if r["global_rms"] > 1.5 * JAX_GNSS["global_rms_f64"] + 0.05:
        return f"global nodes' RMS error {r['global_rms']:.4f} m", launches, gf
    return None, launches, gf


def dynamic_main_path(dev, card):
    """Phase 11. Returns (error or None, launches during the drive, the
    inputs of one occluded tick's mask for kernel R's check)."""
    import dataclasses

    import torch
    from ground_fusion2_tpu_torch import _kernels, checks
    from ground_fusion2_tpu_torch.config import m3dgr_system
    from ground_fusion2_tpu_torch.system import GroundFusion

    t0 = time.perf_counter()
    frames = checks.dynamic_drive(DYN_FRAMES)
    print(f"dynamic drive: {DYN_FRAMES} frames rendered and scanned in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gf = GroundFusion(dataclasses.replace(m3dgr_system(), auto_dyn_mask=True),
                      tic=np.zeros(3), ric=checks.RIG_RIC, tio=np.zeros(3),
                      rio=np.eye(3), device=dev)
    fv = gf.vio
    vio, tick_ms, present, free = [], [], [], []
    pair = None
    _kernels.launches.clear()
    for k, f in enumerate(frames):
        if k == DYN_FRAMES // 2 and fv.carry is not None:
            # kernel R's inputs on this fused tick, as _tick_mask forms them
            s = fv.depth_stride
            lo = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
            pair = dict(prev=fv._prev_lo, cur=(
                lo(f["gray"][::s, ::s]).to(torch.float32) * (1.0 / 255.0),
                lo(np.asarray(f["depth"], np.float16)[::s, ::s]).to(
                    torch.float32)), K=fv._K_lo(), cfg=fv.dyn_cfg, up=s,
                out_hw=f["gray"].shape,
                base=torch.zeros(f["gray"].shape, device=dev))
            pair["R_pc"], pair["t_pc"] = fv._predict_rel_motion(f["imu"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = gf.process_camera_image(f["t"], f["gray"], f["depth"], f["imu"],
                                      wheel_vel=f["wheel"])
        gf.process_lidar(f["t"], f["pts"], f["alpha"], f["valid"], f["imu"])
        torch.cuda.synchronize()
        if fv.carry is not None:
            tick_ms.append((time.perf_counter() - t1) * 1e3)
        if out is not None and out.initialized:
            vio.append(out)
        if k == 0:
            continue
        tr = fv.carry.tracker if fv.carry is not None else fv.tracker
        mask = fv.last_mask.cpu().numpy()
        if f["box"] is not None:
            present.append(dict(tick=k, **checks.mask_on_box(
                mask, tr.uv.cpu().numpy(), tr.alive.cpu().numpy(), f["box"])))
        else:
            free.append(float(np.mean(mask > 0.5)))
    out = gf.flush()
    if out is not None and out.initialized:
        vio.append(out)
    launches = dict(_kernels.launches)
    if not (gf.vio.initialized and gf.lio.initialized) or not vio:
        return "an estimator never initialized", launches, pair
    if any(launches.get(k, 0) <= 0 for k in MASK_KERNELS):
        return f"kernel R did not launch: {launches}", launches, pair
    if not prior_finite(fv):
        return "non-finite marginalization prior", launches, pair
    r = checks.system_errors(gf.trajectory, vio, frames)
    cover = min(p["cover"] for p in present)
    on_patch = max(p["live_on_patch"] for p in present)
    share = (f"mean {float(np.mean(free)):.6f} max {float(np.max(free)):.6f}"
             if free else "not measured")
    print(f"dynamic path: {len(tick_ms)} fused ticks, median tick "
          f"{float(np.median(tick_ms[2:])):.2f} ms (synchronized wall), "
          f"occluder in view on {len(present)} ticks: least cover "
          f"{cover:.4f} (JAX 1.0), most live slots on it {on_patch} (JAX 0); "
          f"mask share on {len(free)} occluder-free ticks {share} (JAX "
          f"{JAX_MASK_FREE['mean']:.6f} / {JAX_MASK_FREE['max']:.6f}), fused "
          f"error {r['fused_err']:.4f} m, VIO ATE {r['vio_ate']:.4f} m, "
          f"launches {launches} | {card}", flush=True)
    if cover < MASK_COVER:
        return f"the mask covers only {cover:.3f} of the occluder", launches, pair
    if on_patch:
        return f"{on_patch} live slots on the occluder", launches, pair
    if not r["fused_err"] < SYS_MAX_ERR:
        return f"fused error {r['fused_err']:.4f} m", launches, pair
    if not r["vio_ate"] < SYS_MAX_ATE:
        return f"VIO ATE {r['vio_ate']:.4f} m", launches, pair
    return None, launches, pair


def system_ticks(gf, frames, profile_last: int = 0):
    """GroundFusion ``gf`` over ``frames`` (process_camera_image then
    process_lidar); (the synchronized wall of each tick with both carries
    live in ms, the torch.profiler trace of the last ``profile_last``
    ticks or None)."""
    import torch
    tick_ms, prof = [], None
    for k, f in enumerate(frames):
        live = gf.vio.carry is not None and gf.lio.carry is not None
        if live and k >= len(frames) - profile_last and prof is None:
            prof = start_profiler()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        gf.process_camera_image(f["t"], f["gray"], f["depth"], f["imu"],
                                wheel_vel=f["wheel"])
        gf.process_lidar(f["t"], f["pts"], f["alpha"], f["valid"], f["imu"])
        torch.cuda.synchronize()
        if live:
            tick_ms.append((time.perf_counter() - t1) * 1e3)
    if prof is not None:
        prof.__exit__(None, None, None)
    return tick_ms, prof


def occupancy_main_path(dev, card, frames, sys_median_ms):
    """Phase 13: GroundFusion(m3dgr_system() with use_occupancy_grid) over
    ``frames`` (phase 8's drive), each frame process_camera_image then
    process_lidar. Kernel Z must launch on every fused sweep; on the last
    sweep it is held against its plain version (the grid before that sweep
    kept on the side: the pipelined LIO's flush); the grid's occupied and free cell counts are printed
    beside the JAX package's; save_grid_map then OccupancyGrid.load must give
    prob() back within one grey level. Returns (error or None, launches,
    Z's check)."""
    import dataclasses
    import pathlib

    import torch
    from ground_fusion2_tpu_torch import _kernels, checks
    from ground_fusion2_tpu_torch.config import m3dgr_system
    from ground_fusion2_tpu_torch.mapping.occupancy import OccupancyGrid
    from ground_fusion2_tpu_torch.system import GroundFusion

    gf = GroundFusion(dataclasses.replace(m3dgr_system(),
                                          use_occupancy_grid=True),
                      tic=np.zeros(3), ric=checks.RIG_RIC, tio=np.zeros(3),
                      rio=np.eye(3), device=dev)
    # the host wall of each grid feed (OccupancyGrid.update, unsynchronized)
    feed_ms, update = [], gf.occ_grid.update

    def timed_update(*a, **k):
        t = time.perf_counter()
        update(*a, **k)
        feed_ms.append((time.perf_counter() - t) * 1e3)
    gf.occ_grid.update = timed_update
    _kernels.launches.clear()
    tick_ms, prof = system_ticks(gf, frames, profile_last=3)
    del gf.occ_grid.update
    # the last sweep: the pipelined LIO's held-back output feeds the grid
    # in flush(), with the last scan's cloud
    before_last = gf.occ_grid.logodds.clone()
    gf.flush()
    launches = dict(_kernels.launches)
    sweeps = sum(o.source == "fused" for o in gf.trajectory)
    p_w, m = gf.lio.last_cloud
    origin = torch.as_tensor(np.asarray(gf.trajectory[-1].p, np.float32)[:2],
                             device=dev)
    z = checks.check_occupancy(dev, gf.occ_grid.cfg, origin, p_w, m > 0.5,
                               before_last)
    p = gf.occ_grid.prob()
    occupied, free = int((p > 0.65).sum()), int((p < 0.2).sum())
    out_dir = pathlib.Path("build") / "phase13"
    out_dir.mkdir(parents=True, exist_ok=True)
    img = str(out_dir / "grid.pgm")
    gf.save_grid_map(img, str(out_dir / "grid.yaml"))
    back = OccupancyGrid.load(img, gf.occ_grid.cfg, dev).prob()
    reload_err = float(np.abs(back - p).max())
    median = float(np.median(tick_ms[2:]))
    # the same drive with the grid off, right after: this point of the
    # run's host wall without the grid
    off_ms, _ = system_ticks(GroundFusion(
        m3dgr_system(), tic=np.zeros(3), ric=checks.RIG_RIC, tio=np.zeros(3),
        rio=np.eye(3), device=dev), frames)
    split = device_split(prof, 3) if prof is not None else {}
    print("system tick split with the grid on over the last 3 ticks "
          f"(torch.profiler, as phase 8's; printed only): {json.dumps(split)}, "
          f"host wall a tick {[round(t, 2) for t in tick_ms[-3:]]} ms, grid "
          f"feed host wall median {float(np.median(feed_ms or [np.nan])):.3f} "
          f"ms, max {max(feed_ms, default=np.nan):.3f} ms over {len(feed_ms)} feeds | {card}",
          flush=True)
    print(f"occupancy path: {len(tick_ms)} system ticks with the grid on, "
          f"{sweeps} fused sweeps, occupancy launches "
          f"{launches.get('occupancy', 0)}, median system tick {median:.2f} ms "
          f"(without the grid: phase 8 {sys_median_ms:.2f} ms, the same drive "
          f"right after {float(np.median(off_ms[2:])):.2f} ms; synchronized "
          f"wall), cells occupied (p > 0.65) {occupied} / free (p < 0.2) "
          f"{free} (JAX {JAX_GRID['occupied']} / {JAX_GRID['free']}), "
          f"save -> load max |Δp| {reload_err:.6f} (limit {OCC_MAX_DIFF:.6f}), "
          f"kernel Z on the last sweep: " + json.dumps(z) + f" | {card}",
          flush=True)
    if launches.get("occupancy", 0) != sweeps or sweeps == 0:
        return (f"kernel Z launched {launches.get('occupancy', 0)} times over "
                f"{sweeps} fused sweeps", launches, z)
    if not z["ok"]:
        return "kernel Z disagrees with its plain version", launches, z
    if not prior_finite(gf.vio):
        return "non-finite marginalization prior", launches, z
    if not reload_err <= OCC_MAX_DIFF:
        return f"the saved grid reloads {reload_err:.6f} off", launches, z
    return None, launches, z


def mesh_main_path(dev, card, frames, sys_median_ms):
    """Phase 14: GroundFusion(m3dgr_system() with use_mesh and the M3DGR
    intrinsics as mesh_intrinsics) over ``frames`` (phase 8's drive), each
    frame process_camera_image then process_lidar with the grey frame as a
    three-channel texture and the latest VIO pose composed with the rig's
    extrinsic (checks.mesh_texture, as data/m3dgr_sim.py:392-404 feeds it),
    then flush. AA must launch once an insert chunk, AB once a textured
    sweep, AC once a drain that has voxels pending (its wrapper calls equal
    those drains); every fused pose finite and the fused error <
    SYS_MAX_ERR; on the last calls AA, AB and AC are held against their
    plain versions; export_mesh's PLY header counts equal stats().
    Printed: the mesh's figures beside the JAX package's, the system tick
    beside phase 8's, the mesh feed's host wall and syncs a sweep and
    torch.profiler's split of the last 3 ticks. Returns (error or None,
    launches, the three checks)."""
    import dataclasses
    import pathlib

    import torch
    from ground_fusion2_tpu_torch import _kernels, checks
    from ground_fusion2_tpu_torch.config import m3dgr_system
    from ground_fusion2_tpu_torch.mesh import incremental as mi
    from ground_fusion2_tpu_torch.system import GroundFusion

    gf = GroundFusion(dataclasses.replace(
        m3dgr_system(), use_mesh=True,
        mesh_intrinsics=checks.M3DGR_INTRINSICS), tic=np.zeros(3),
        ric=checks.RIG_RIC, tio=np.zeros(3), rio=np.eye(3), device=dev)
    mesher, cfg = gf.mesher, gf.mesher.cfg
    feed_ms, feed_syncs, sites = [], [], collections.Counter()
    add_frame = mesher.add_frame
    watch = [False]

    def timed_add(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if not watch[0]:
            add_frame(*a, **k)
            torch.cuda.synchronize()
            feed_ms.append((time.perf_counter() - t) * 1e3)
            return
        got = collections.Counter()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = sync_site(got)
            torch.cuda.set_sync_debug_mode("warn")
            add_frame(*a, **k)
            torch.cuda.set_sync_debug_mode("default")
        feed_syncs.append(sum(got.values()))
        sites.update(got)
    mesher.add_frame = timed_add
    drain, drains = mesher._drain, [0]

    def counted_drain():
        drains[0] += bool(mesher._pending)
        drain()
    mesher._drain = counted_drain
    vio, tick_ms, prof = [], [], None
    _kernels.launches.clear()
    with CallCounter(mi, "insert") as ins, \
            CallCounter(mi, "update_rgb") as rgb, \
            CallCounter(mi, "retriangulate_packed") as tri:
        for k, f in enumerate(frames):
            live = gf.vio.carry is not None and gf.lio.carry is not None
            watch[0] = live and k >= len(frames) - 3
            if watch[0] and prof is None:
                prof = start_profiler()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = gf.process_camera_image(f["t"], f["gray"], f["depth"],
                                          f["imu"], wheel_vel=f["wheel"])
            gf.process_lidar(f["t"], f["pts"], f["alpha"], f["valid"],
                             f["imu"], **checks.mesh_texture(gf, f["gray"]))
            torch.cuda.synchronize()
            if live:
                tick_ms.append((time.perf_counter() - t1) * 1e3)
            if out is not None and out.initialized:
                vio.append(out)
        if prof is not None:
            prof.__exit__(None, None, None)
        watch[0] = False
        out = gf.flush()
        if out is not None and out.initialized:
            vio.append(out)
        torch.cuda.synchronize()
    del mesher.add_frame, mesher._drain
    launches = dict(_kernels.launches)
    calls = dict(mesh_insert=ins.n, mesh_rgb=rgb.n, mesh_delaunay=tri.n)
    res = {}
    if ins.recent and rgb.recent and tri.recent:
        # the last sweep's chunk, the last textured sweep, and the last full
        # batch the last drain retriangulated
        m0, p, msk, _ = ins.recent[-1]
        res["mesh_insert"] = checks.check_mesh_insert(dev, m0, p, msk, cfg)
        m1, img, intr, r_wc, t_wc, _ = rgb.recent[-1]
        res["mesh_rgb"] = checks.check_mesh_rgb(dev, m1, img, intr, r_wc,
                                                t_wc, cfg)
        # the largest of the last drains' voxel sets, in one launch
        m2, codes, _ = max(tri.recent, key=lambda a: a[1].numel())
        res["mesh_delaunay"] = checks.check_mesh_delaunay(dev, m2, codes, cfg)
    st = mesher.stats()
    live_rows = mesher.mesh.code != mi.INVALID
    textured = float((mesher.mesh.w[live_rows] > 0).float().mean()) \
        if bool(live_rows.any()) else 0.0
    out_dir = pathlib.Path("build") / "phase14"
    out_dir.mkdir(parents=True, exist_ok=True)
    nv, nf = gf.export_mesh(str(out_dir / "mesh.ply"))
    with open(out_dir / "mesh.ply") as fh:
        head = [next(fh).strip() for _ in range(12)]
    header_ok = (f"element vertex {st['vertices']}" in head
                 and f"element face {st['triangles']}" in head
                 and (nv, nf) == (st["vertices"], st["triangles"]))
    r = checks.system_errors(gf.trajectory, vio, frames)
    split = device_split(prof, 3) if prof is not None else {}
    median = float(np.median(tick_ms[2:])) if len(tick_ms) > 2 else np.nan
    print("system tick split with the mesh on over the last 3 ticks "
          f"(torch.profiler, as phase 8's; printed only): {json.dumps(split)}, "
          f"host wall a tick {[round(t, 2) for t in tick_ms[-3:]]} ms; mesh "
          f"feed (add_frame: inserts, texture, the drain) synchronized host "
          f"wall a sweep median {float(np.median(feed_ms or [np.nan])):.3f} "
          f"ms, max {max(feed_ms, default=np.nan):.3f} ms over "
          f"{len(feed_ms)} unwatched sweeps; synchronizing calls a sweep "
          f"{feed_syncs} over the last 3 (by call site "
          f"{dict(sites.most_common())}) | {card}", flush=True)
    ac_tick = split.get("by_kernel_ms_per_tick", {}).get("AC", float("nan"))
    print(f"kernel AC on the mesh path: {launches.get('mesh_delaunay', 0)} "
          f"launches over {drains[0]} drains with voxels pending "
          f"({launches.get('mesh_delaunay', 0) / max(drains[0], 1):g} a "
          f"drain; {tri.n} wrapper calls), {ac_tick:.4f} device ms a tick "
          f"over the last 3 ticks (torch.profiler), the last drains' voxels "
          f"{[int((a[1] != mi.INVALID).sum()) for a in tri.recent]} | {card}",
          flush=True)
    print(f"mesh path: {len(tick_ms)} system ticks with the mesh on, median "
          f"system tick {median:.2f} ms (phase 8 without it: "
          f"{sys_median_ms:.2f} ms; synchronized wall), fused position error "
          f"{r['fused_err']:.4f} m max over {r['n_fused']} outputs, VIO ATE "
          f"{r['vio_ate']:.4f} m; mesh {st} (JAX {JAX_MESH['stats']}), "
          f"textured share of live vertices {textured:.4f} (JAX "
          f"{JAX_MESH['textured']:.4f}); PLY header {nv} vertices / {nf} "
          f"faces; wrapper calls {calls}, launches {launches} | {card}",
          flush=True)
    for name, c in res.items():
        print(f"kernel {name} on the last call: " + json.dumps(c) + f" | {card}",
              flush=True)
    grew = {k: launches.get(k, 0) for k in calls}
    if grew != calls or min(calls.values()) == 0:
        return (f"mesh kernels launched {grew} for wrapper calls {calls}",
                launches, res)
    if tri.n != drains[0]:
        return (f"kernel AC ran {tri.n} calls over {drains[0]} drains: one "
                "launch a drain", launches, res)
    if not all(np.all(np.isfinite(o.p)) and np.all(np.isfinite(o.q))
               for o in gf.trajectory):
        return "a non-finite fused pose", launches, res
    if not r["fused_err"] < SYS_MAX_ERR:
        return (f"fused position error {r['fused_err']:.4f} m >= "
                f"{SYS_MAX_ERR} m"), launches, res
    if not prior_finite(gf.vio):
        return "non-finite marginalization prior", launches, res
    bad = [n for n, c in res.items() if not c["ok"]]
    if bad:
        return f"kernel(s) disagree with their plain version: {bad}", \
            launches, res
    if not header_ok or st["triangles"] == 0:
        return f"the exported PLY's header {head} against {st}", launches, res
    return None, launches, res


def lines_main_path(dev, card, frames):
    """Phase 15: detect_lines on every frame, track_lines on every pair
    (3-level pyramids). Returns (error or None, launches, the last pair's
    pyramids, segments and flags for :func:`line_checks`)."""
    import torch
    from ground_fusion2_tpu_torch import _kernels
    from ground_fusion2_tpu_torch.frontend import klt, lines

    imgs = [torch.as_tensor(f["gray"], device=dev).to(torch.float32) / 255.0
            for f in frames]
    torch.cuda.synchronize()
    _kernels.launches.clear()
    t0 = time.perf_counter()
    valid, tracked, prev, last = [], [], None, None
    for img in imgs:
        segs, ok = lines.detect_lines(img)
        pyr = klt.build_pyramid(img, 3)
        if prev is not None:
            tracked.append(lines.track_lines(prev[0], pyr, prev[1], prev[2])[1])
            last = (prev[0], pyr, prev[1], prev[2])
        valid.append(ok)
        prev = (pyr, segs, ok)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / len(imgs)
    launches = dict(_kernels.launches)
    valid = [int(v.sum()) for v in valid]
    tracked = [int(v.sum()) for v in tracked]
    n = len(imgs)
    print(f"line path: {n} frames, {wall:.3f} ms a frame (synchronized host "
          f"wall, detection + pyramid + tracking); valid segments a frame "
          f"{valid} (JAX {JAX_LINES['valid']}), tracked a pair {tracked} "
          f"(JAX {JAX_LINES['tracked']}); launches {launches} | {card}",
          flush=True)
    want = dict(line_detect=n, line_refit=2 * (n - 1), klt=n - 1)
    got = {k: launches.get(k, 0) for k in want}
    if got != want:
        return f"line path launches {got}, expected {want}", launches, last
    for key, port in (("valid", valid), ("tracked", tracked)):
        ref = sum(JAX_LINES[key][:len(port)])
        if abs(sum(port) - ref) > LINE_COUNT_TOL * ref:
            return (f"{key} segments {sum(port)} against JAX's {ref} (more "
                    f"than {LINE_COUNT_TOL:.0%} apart)"), launches, last
    return None, launches, last


def line_checks(dev, last) -> dict:
    """AD on the last pair's first frame, AE and B on the pair."""
    from ground_fusion2_tpu_torch import checks
    pyr0 = last[0]
    return {"line_detect": checks.check_line_detect(dev, pyr0[0]),
            "line_refit": checks.check_line_refit(dev, *last)}


def dist_main_path(dev, card):
    """Phase 16: the two distributed solvers over a one-rank NCCL group
    and their gates. Returns (error or None, launches, what
    :func:`dist_checks` holds AF, AG and W on)."""
    import shutil
    import tempfile

    import torch
    from ground_fusion2_tpu_torch import _kernels, checks
    from ground_fusion2_tpu_torch.config import VioConfig
    from ground_fusion2_tpu_torch.core import lie
    from ground_fusion2_tpu_torch.parallel import dist_ba as db
    from ground_fusion2_tpu_torch.parallel import dist_mapping as dm
    from ground_fusion2_tpu_torch.parallel.dryrun import process_group
    from ground_fusion2_tpu_torch.vio.problem import solve_window

    cfg = VioConfig(num_feats=DIST_F)
    x0, feats, layout, _ = checks.example_window(DIST_F, dev)
    meas = checks.example_measurements(x0, feats, layout, dev)
    x_single = solve_window(x0, meas, layout, cfg).state
    prob, (gt_p, _, _) = dm.make_mapping_problem(
        MAP_K, MAP_LPK, MAP_HALO, seed=1, pix_noise=0.0, perturb=0.05)
    store = tempfile.mkdtemp(prefix="gf2_nccl_")
    try:
        with process_group("nccl", 0, 1, store) as group:
            solver = db.make_distributed_solver(group, layout, cfg,
                                                DIST_ITERS, dev)
            msolve = dm.make_mapping_solver(group, MAP_K, MAP_HALO,
                                            MAP_ITERS, device=dev)
            torch.cuda.synchronize()
            _kernels.launches.clear()
            t0 = time.perf_counter()
            x_dist, cost = solver(*db.shard_window(x0, meas, 0, 1))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            x_stay, _ = solver(*db.shard_window(x_single, meas, 0, 1))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            p, q, rho, mcost = msolve(dm.shard_problem(prob, 0, 1))
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            launches = dict(_kernels.launches)
            sh = dm.MappingProblem(*(t.to(dev) for t in prob))
            pe, qe = dm.halo_exchange(sh.kf_p, sh.kf_q, MAP_HALO, group)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    d = float((x_dist.p - x_single.p).norm(dim=-1).max())
    moved = float((x_stay.p - x_single.p).norm(dim=-1).max())
    dth = float(lie.quat_boxminus(x_dist.q, x_single.q).norm(dim=-1).max())
    m_err = float(np.linalg.norm(p.cpu().numpy() - gt_p, axis=1).max())
    finite = bool(torch.isfinite(x_dist.p).all() and torch.isfinite(p).all()
                  and torch.isfinite(rho).all())
    print(f"distributed window solve (world 1, NCCL, F = {DIST_F}, "
          f"{DIST_ITERS} LM iterations): cost {float(cost):.6f}, "
          f"{(t1 - t0) * 1e3:.2f} ms; against solve_window: max position "
          f"gap {d:.6f} m (gate {DIST_MAX_D}), rotation {dth:.6f} rad; warm "
          f"start moved {moved:.3e} m (gate {DIST_STAY}), "
          f"{(t2 - t1) * 1e3:.2f} ms | {card}", flush=True)
    print(f"distributed mapping solve (world 1, NCCL, K = {MAP_K}, lpk "
          f"{MAP_LPK}, halo {MAP_HALO}, {MAP_ITERS} iterations): max pose "
          f"error {m_err:.6f} m (gate {MAP_MAX_ERR}), cost {float(mcost):.3e} "
          f"(gate {MAP_MAX_COST}); JAX on one CPU device {JAX_MAP}; "
          f"{(t3 - t2) * 1e3:.2f} ms; launches {launches} | {card}",
          flush=True)
    ctx = (x0, feats, meas, layout, cfg, pe, qe, sh)
    if any(launches.get(k, 0) <= 0 for k in DIST_KERNELS + ("chol_solve",)):
        return f"distributed solves launched {launches}", launches, ctx
    if not finite:
        return "a non-finite distributed solve", launches, ctx
    if not (d < DIST_MAX_D and moved < DIST_STAY):
        return (f"distributed window: gap {d:.6f} m, warm start moved "
                f"{moved:.3e} m"), launches, ctx
    if not (m_err < MAP_MAX_ERR and float(mcost) < MAP_MAX_COST):
        return (f"mapping: pose error {m_err:.6f} m, cost "
                f"{float(mcost):.3e}"), launches, ctx
    return None, launches, ctx


def dist_checks(dev, ctx) -> dict:
    """AF at the window's start, AG at the mapping's, and W's
    explicit-diagonal mode on the systems the two solvers damp there."""
    import torch
    from ground_fusion2_tpu_torch import checks
    from ground_fusion2_tpu_torch.parallel import dist_ba as db
    from ground_fusion2_tpu_torch.parallel import dist_mapping as dm
    x0, feats, meas, layout, cfg, pe, qe, sh = ctx
    lam = torch.full((), 1e-4, device=dev)
    res = {"dist_schur": checks.check_dist_schur(dev, x0, feats, layout, cfg),
           "map_schur": checks.check_map_schur(dev, pe, qe, sh, MAP_HALO,
                                               MAP_K, 0)}
    red = db.shard_reduce(x0, feats, layout, cfg, lam)
    Hr, gr, dr = red.unpack(layout.frame_dim)
    Hd, gd, _ = db.dense_normal_equations(x0, meas, layout, cfg)
    free = db.free_mask(layout, cfg, meas, dev)
    res["chol_solve (window, explicit diagonal)"] = checks.check_chol_solve(
        dev, Hr + Hd, gr + gd, free, damp_diag=(dr + torch.diagonal(Hd)) * free,
        timed=False)
    b = dm.map_build(pe, qe, sh, MAP_HALO, MAP_K, 0, lam)
    K6 = MAP_K * 6
    mfree = torch.ones(K6, device=dev)
    mfree[:6] = 0.0
    res["chol_solve (mapping, explicit diagonal)"] = checks.check_chol_solve(
        dev, b.pay[:, :K6], b.pay[:, K6], mfree,
        damp_diag=b.pay[:, K6 + 1] * mfree)
    return res


def window_stage_checks(dev, fv) -> dict:
    """Phase 7's T, U and V on FusedVio ``fv``'s final carry: triangulation
    of every live track (the RGB-D depth fix cleared, none initialized), the
    tests before the solve (interval W-2) and after it (at the fused tick's
    thresholds), and the three window updates (add_frame of the newest
    column's observations, the unobserved live tracks fresh; both slides)."""
    import torch
    from ground_fusion2_tpu_torch import checks
    fw, st, obs, interval = checks.window_stage_inputs(fv)
    W = fw.obs_valid.shape[1]
    tri = fw._replace(depth_fixed=torch.zeros_like(fw.depth_fixed))
    return {
        "triangulate": checks.check_triangulate(
            dev, tri, st, st.rho, torch.ones_like(st.rho)),
        "window_tests": checks.check_window_tests(
            dev, fw, st, fv.statics,
            torch.zeros((), dtype=torch.bool, device=dev), interval, W - 2),
        "window_update": checks.check_window_update(dev, fw, st, st.rho, obs,
                                                    W - 1),
    }


def gnss_refresh_path(dev, card):
    """Phase 10b: GroundFusion at groundchallenge_gnss() with the anchor
    refresh bound at RR_REFRESH_M and the yaw refine every RR_PERIOD GNSS
    ticks, over RR_FRAMES frames of checks.gnss_drive with an epoch on every
    frame (the cut depth of tests/test_torch_gnss_fused.py's refresh and
    refine drive). Counts the refreshes and the refines that move the yaw
    (10 velocity pairs); fails if either count is 0, if they fire on other
    frames than JAX's or if a refined yaw is off JAX's at float64 (JAX_RR)
    by more than RR_YAW_TOL. Returns the error or None."""
    import dataclasses
    import torch
    from ground_fusion2_tpu_torch import checks
    from ground_fusion2_tpu_torch.config import groundchallenge_gnss
    from ground_fusion2_tpu_torch.core.cameras import Pinhole
    from ground_fusion2_tpu_torch.system import GroundFusion, SystemConfig

    frames = checks.gnss_drive(RR_FRAMES, epoch_every=1)
    cam = groundchallenge_gnss()
    est = dataclasses.replace(cam.estimator, gnss_anchor_refresh_m=RR_REFRESH_M,
                              gnss_refine_period_ticks=RR_PERIOD)
    gf = GroundFusion(SystemConfig(
        vio=est, use_lidar=False, tracker=cam.tracker,
        cam=Pinhole.create(*cam.intrinsics), cam_intr=cam.intrinsics),
        tic=frames[0]["tic"], ric=frames[0]["ric"], tio=np.zeros(3),
        rio=np.eye(3), device=dev)
    fv = gf.vio
    fired = dict(refresh=[], refine=[], yaw=[])
    refresh, refine = fv._gnss_refresh_anchor, fv._gnss_refine_yaw
    tick = [0]

    def on_refresh():
        refresh()
        fired["refresh"].append(tick[0])

    def on_refine():
        n = len(fv._gnss_vel_pairs)
        refine()
        if n >= 10:
            fired["refine"].append(tick[0])
            fired["yaw"].append(round(float(fv.carry.state.gyaw), 6))

    fv._gnss_refresh_anchor, fv._gnss_refine_yaw = on_refresh, on_refine
    t0 = time.perf_counter()
    for k, f in enumerate(frames):
        tick[0] = k
        o = gf.process_camera(f["t"], f["obs"], f["imu"], wheel_vel=f["wheel"],
                              gnss_meas=f["gnss"])
        if o is not None and o.initialized and not np.all(np.isfinite(o.p)):
            return f"non-finite state at t={f['t']:.2f} (phase 10b)"
    torch.cuda.synchronize()
    print(f"gnss refresh/refine: {RR_FRAMES} frames in "
          f"{time.perf_counter() - t0:.1f} s, anchor refreshes on frames "
          f"{fired['refresh']} (JAX {JAX_RR['refresh']}), yaw refines on "
          f"frames {fired['refine']} (JAX {JAX_RR['refine']}), yaw after each "
          f"{fired['yaw']} (JAX with the port's f64 elimination "
          f"{[round(y, 6) for y in JAX_RR['yaw_f64']]}; its own f32 "
          f"{[round(y, 6) for y in JAX_RR['yaw']]}, its own eigh's "
          f"rounding, as phase 10's ATE) | {card}", flush=True)
    if not fired["refresh"] or not fired["refine"]:
        return (f"the GNSS anchor refresh ({len(fired['refresh'])}) or the "
                f"yaw refine ({len(fired['refine'])}) never fired")
    if (fired["refresh"], fired["refine"]) != (JAX_RR["refresh"],
                                               JAX_RR["refine"]):
        return "the refresh or refine fired on other frames than JAX's"
    off = max(abs(a - b) for a, b in zip(fired["yaw"], JAX_RR["yaw_f64"]))
    if off > RR_YAW_TOL:
        return (f"a refined yaw is {off:.4f} rad from JAX's at float64 "
                f"(limit {RR_YAW_TOL})")
    return None


def camera_models_path(dev, card, frames, windows):
    """Phase 17: kernel AH's lift and tail modes against the plain route for
    each camera model, then phase 4's drive with the M3DGR intrinsics as a
    PinholeFull of zero coefficients, whose windows must equal ``windows``
    (phase 4's first run) tick for tick. Returns (error or None, the
    check)."""
    import torch
    from ground_fusion2_tpu_torch import checks
    from ground_fusion2_tpu_torch.config import m3dgr_camera
    from ground_fusion2_tpu_torch.core.cameras import PinholeFull
    res = checks.check_camera_models(dev, checks.camera_cases())
    for name, m in res["models"].items():
        print(f"kernel AH with the {name} camera ({m['model']}, "
              f"{m['image'][0]}×{m['image'][1]}, F = 150 slots: "
              f"{json.dumps(m['slots'])}): "
              + ", ".join(
                  f"{mode} mode torch.equal {m[mode]['equal']}, twice the "
                  f"same bits {m[mode]['repeat_equal']}, device ms a call "
                  f"{m[mode]['device_ms']:.4f}, launches a call "
                  f"{m[mode]['launches_per_call']:g} (host-inclusive call ms "
                  f"{m[mode]['ms']:.4f}, the plain route "
                  f"{m[mode]['plain_ms']:.4f})" for mode in ("lift", "tail"))
              + f" | {card}", flush=True)
    if not res["ok"]:
        return "kernel AH disagrees with its plain route for a camera model", res
    print("phase 17: no drive of a fisheye rig is rendered: the port's "
          "renderer (data/render.py, a copy of the JAX package's) is "
          "pinhole-only, so the JAX package has no such drive either",
          flush=True)
    cfg = m3dgr_camera()
    (err, _, _, run), lin = linalg_free(
        "17", camera_main_path, dev, card, frames,
        PinholeFull.create(*cfg.intrinsics))
    if err or lin:
        return err or lin, res
    got = run["windows"]
    differ = [k for k, (a, b) in enumerate(zip(windows, got))
              if not torch.equal(a, b)]
    print(f"phase 17: phase 4's drive with the camera as a PinholeFull of "
          f"zero coefficients: ATE {run['ate']:.6f} m, windows "
          + (f"first differ from phase 4's at fused tick {differ[0] + 1}"
             if differ else f"equal to phase 4's on all {len(got)} fused "
             "ticks") + f" | {card}", flush=True)
    if differ or len(got) != len(windows):
        return (f"the PinholeFull drive's windows differ from phase 4's "
                f"({len(got)} ticks against {len(windows)}, first differing "
                f"{differ[:1]})"), res
    return None, res


def calib_main_path(dev, card):
    """Phase 18: calibrate_pinhole_full and calibrate_pinhole on 40 views of
    a 12 × 8 board (checks.calib_views), and calibrate_pinhole on them with
    0.3 px of noise, each gated on tests/test_calib_intrinsics.py's truths,
    then kernel AP against its plain version at δ = 0 and at the LM's final
    δ. Returns (error or None, AP's launches over the three calibrations,
    AP's check at D = 252)."""
    import torch
    from ground_fusion2_tpu_torch import _kernels, checks
    from ground_fusion2_tpu_torch.calib import intrinsics as ci
    ap_launches, ap = 0, None
    xy = ("fx", "fy", "cx", "cy")
    for name, rational, noise, iters, fn, px, rms_max, keys in (
            ("calibrate_pinhole_full", True, 0.0, 40,
             ci.calibrate_pinhole_full, 1.5, 0.1, xy),
            ("calibrate_pinhole", False, 0.0, 30, ci.calibrate_pinhole, 2.0,
             0.1, xy),
            ("calibrate_pinhole, 0.3 px noise", False, 0.3, 30,
             ci.calibrate_pinhole, 8.0, 0.6, ("fx", "cx"))):
        obj, uv = checks.calib_views(rational, noise=noise)
        truth = checks.CALIB_RATIONAL if rational else checks.CALIB_RADTAN
        _kernels.launches.clear()
        torch.cuda.synchronize()
        with CallCounter(torch.func, "jacfwd") as jac:
            t0 = time.perf_counter()
            out = fn(obj, uv, device=dev)
            wall = (time.perf_counter() - t0) * 1e3
        launches = {k: _kernels.launches.get(k, 0)
                    for k in ("calib_normal", "chol_solve", "lm_glue")}
        ap_launches += launches["calib_normal"]
        dt = checks.device_ms(lambda: fn(obj, uv, device=dev), reps=3,
                              warmup=1)
        errs = {k: abs(float(getattr(out, k)) - truth[k]) for k in xy}
        D = (12 if rational else 8) + 6 * uv.shape[0]
        print(f"{name}: {uv.shape[0]} views of a 12 × 8 board ("
              f"{2 * uv.shape[0] * uv.shape[1]} rows, D = {D}), {iters} LM "
              f"iterations: rms {out.rms_px:.3e} px, |Δ| from the truth "
              + json.dumps({k: round(v, 6) for k, v in errs.items()})
              + f" px; wall {wall:.1f} ms (numpy initialization included), "
              f"device ms a calibration {dt.ms:.4f} in {dt.launches:g} CUDA "
              f"activities (torch.profiler; by kernel: "
              + json.dumps({kernel_qualname(k).replace(ANON, ""): round(v, 4)
                            for k, v in sorted(dt.kernels.items(),
                                               key=lambda kv: -kv[1])[:5]})
              + f"), launches {json.dumps(launches)}, "
              f"torch.func.jacfwd calls {jac.n} | {card}", flush=True)
        if not (out.rms_px < rms_max
                and max(errs[k] for k in keys) < px):
            return (f"{name} misses the truth gates (rms {out.rms_px} "
                    f"< {rms_max}, {errs} < {px} px on {keys})"), \
                ap_launches, ap
        if jac.n or min(launches.values()) <= 0:
            return (f"{name} ran jacfwd {jac.n} times or left a kernel "
                    f"unlaunched: {launches}"), ap_launches, ap
        prob = ci.calib_problem(obj, uv, 12 if rational else 8, dev)
        lm = ci.solve(prob, iters)
        chk = checks.check_calib(
            dev, prob, dict(zero=torch.zeros(prob.dim, device=dev),
                            final=lm.delta), timed=rational)
        print(f"kernel AP ({name}, D = {prob.dim}) against its plain version: "
              + json.dumps(chk) + f" | {card}", flush=True)
        if not chk["ok"]:
            return f"kernel AP disagrees with its plain version ({name})", \
                ap_launches, ap
        ap = ap or chk
    return None, ap_launches, ap


STEREO_F = 150
STEREO_MAX_ERR = 0.01   # m, tests/test_window_ba.py's stereo gate


def stereo_main_path(dev, card):
    """Phase 19: the stereo window on the card (``checks.stereo_window`` at
    F = 150, W = 11: the example window and a second camera 0.05 m along
    the first's x axis): kernel C's stereo family against its plain route,
    kernel S's at the start, the damped step and its reverse, then
    ``solve_window`` and ``marginalize_oldest`` with ``use_stereo``, their
    synchronizing calls counted and both kernels' launches. Returns (error
    or None, the checks)."""
    import torch
    from ground_fusion2_tpu_torch import _kernels, checks
    from ground_fusion2_tpu_torch.solver.gauss_newton import _solve_damped
    from ground_fusion2_tpu_torch.vio import problem
    sw = checks.stereo_window(STEREO_F, dev)
    cfg = checks.stereo_config(STEREO_F)
    x0, meas, layout = sw["x0"], sw["meas"], sw["layout"]
    res = {"proj_normal (stereo)": checks.check_proj(
        dev, x0, sw["feats"], layout, sw["delta"], cfg.proj_sqrt_info,
        stereo=sw["stereo"])}
    zero = torch.zeros(layout.dim, device=dev)
    H0, g0, _ = problem.window_normal_equations(x0, meas, layout, cfg, zero)
    step = _solve_damped(H0, g0, torch.full((), 1e-4, device=dev),
                         torch.ones(layout.dim, device=dev))
    res["window_cost (stereo)"] = checks.check_window_cost(
        dev, x0, meas, layout, cfg, dict(zero=zero, step=step, back=-step))
    print("phase 19: kernels C and S with the stereo rows on the stereo "
          f"window (F = {STEREO_F}, W = {layout.W}, "
          f"{int(sw['stereo'][1].sum())} second-camera observations): "
          + json.dumps(res) + f" | {card}", flush=True)
    if report(res):
        return "kernel C or S disagrees on the stereo window", res
    solve = lambda: problem.solve_window(x0, meas, layout, cfg)
    # the layout's device tables once, as FusedVio.build_carry makes them,
    # then a warm solve and elimination
    problem.prepare_layout(layout, cfg, dev)
    problem.marginalize_oldest(solve().state, meas, layout, cfg)
    torch.cuda.synchronize()
    _kernels.launches.clear()
    sites = collections.Counter()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = sync_site(sites)
        torch.cuda.set_sync_debug_mode("warn")
        out = solve()
        prior = problem.marginalize_oldest(out.state, meas, layout, cfg)
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = dict(_kernels.launches)
    err = float((out.state.p - sw["p_true"]).norm(dim=-1).max())
    err0 = float((x0.p - sw["p_true"]).norm(dim=-1).max())
    finite = bool(torch.isfinite(prior.sqrt_J).all()
                  and torch.isfinite(prior.r0).all())
    res["solve"] = dict(max_pos_err=err, start_err=err0, wall_ms=wall,
                        syncs=dict(sites), launches=launches,
                        prior_finite=finite, cost0=float(out.cost0),
                        cost=float(out.cost))
    print(f"phase 19: solve_window + marginalize_oldest with use_stereo: "
          f"positions {err:.6f} m from the truth at most (start {err0:.4f} "
          f"m; gate {STEREO_MAX_ERR} m), cost {float(out.cost0):.4f} -> "
          f"{float(out.cost):.6f}, prior finite {finite}, synchronizing "
          f"calls {sum(sites.values())} {dict(sites)}, launches {launches}, "
          f"wall {wall:.2f} ms (synchronized) | {card}", flush=True)
    if not err < STEREO_MAX_ERR:
        return (f"the stereo solve leaves a position {err:.4f} m from the "
                f"truth"), res
    if sites:
        return f"the stereo solve synchronized: {dict(sites)}", res
    if not finite:
        return "the stereo MARGIN_OLD prior is not finite", res
    if min(launches.get(k, 0) for k in ("proj_normal", "window_cost")) == 0:
        return f"C or S did not launch in the stereo solve: {launches}", res
    return None, res


def report(res: dict) -> int:
    import torch
    torch.cuda.synchronize()
    for name, r in res.items():
        print(f"kernel {name}: " + json.dumps(r), flush=True)
    bad = [n for n, r in res.items() if not r["ok"]]
    if bad:
        return fail(f"kernel(s) disagree with their plain version: {bad}")
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")
    dev = torch.device(DEVICE)
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    print(card, flush=True)

    from ground_fusion2_tpu_torch import _kernels, checks
    from ground_fusion2_tpu_torch.config import m3dgr_camera
    from ground_fusion2_tpu_torch.core.cameras import Pinhole

    # 2. build
    t0 = time.perf_counter()
    _kernels.build(force=True)
    _kernels.library()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc "
          f"{_kernels.build_seconds:.1f} s)", flush=True)

    # 3. camera kernels vs plain at the main path's shapes
    frames = checks.room_drive(CAM_FRAMES)
    cfg = m3dgr_camera()
    vcfg = cfg.estimator.vio
    x0, feats, layout, delta = checks.example_window(150, dev)
    meas = checks.example_measurements(x0, feats, layout, dev)
    res = {
        "clahe": checks.check_clahe(dev, frames[12]),
        "klt": checks.check_klt(dev, frames[12:14]),
        "proj_normal": checks.check_proj(dev, x0, feats, layout, delta,
                                         vcfg.proj_sqrt_info),
        "small_normal": checks.check_small_normal(dev, x0, meas, layout,
                                                  delta, vcfg),
    }
    if report(res):
        return 1
    c = res["proj_normal"]
    print(f"kernel C (proj_normal) at F = 150, D = {c['dim']}: device ms a "
          f"call {c['device_ms']:.4f}, launches a call "
          f"{c['launches_per_call']:g} (torch.profiler, every CUDA activity; "
          f"host-inclusive call ms {c['ms']:.4f}) | {card}", flush=True)
    c = res["small_normal"]
    print(f"kernel L (small_normal) at F = 150, D = {c['dim']}: device ms a "
          f"linearization {c['device_ms']:.4f} in {c['launches_per_call']:g} "
          f"CUDA activities (its two kernels, the prior's plain products), "
          f"the pack once a solve {c['pack_device_ms']:.4f} ms in "
          f"{c['pack_launches']:g} (torch.profiler; host-inclusive call ms "
          f"{c['ms']:.4f}) | {card}", flush=True)
    from ground_fusion2_tpu_torch.vio.problem import window_normal_equations
    H, g, _ = window_normal_equations(x0, meas, layout, vcfg, delta)
    # W on the window's damped step, X on its two eliminations
    res["chol_solve"] = checks.check_chol_solve(dev, H, g)
    res["sym_eig"] = checks.check_sym_eig(
        dev, checks.marg_systems(x0, meas, layout, vcfg))
    if report({k: res[k] for k in ("chol_solve", "sym_eig")}):
        return 1
    # kernel S at delta = 0 and at the LM step from there (accepted) and its
    # reverse (rejected)
    from ground_fusion2_tpu_torch.solver.gauss_newton import _solve_damped
    zero = torch.zeros(layout.dim, device=dev)
    H0, g0, _ = window_normal_equations(x0, meas, layout, vcfg, zero)
    step = _solve_damped(H0, g0, torch.full((), 1e-4, device=dev),
                         torch.ones(layout.dim, device=dev))
    res["window_cost"] = checks.check_window_cost(
        dev, x0, meas, layout, vcfg,
        dict(zero=zero, accepted=step, rejected=-step))
    dec = res["window_cost"]["decisions"]
    if not (dec["accepted"]["kernel"] and not dec["rejected"]["kernel"]):
        res["window_cost"]["ok"] = False
    res["window_cost"]["ok"] &= res["window_cost"]["decisions_equal"]
    if report({"window_cost": res["window_cost"]}):
        return 1
    c = res["window_cost"]
    print(f"kernel S (window_cost) at F = 150, D = {layout.dim}: device ms a "
          f"call {c['device_ms']:.4f}, launches a call "
          f"{c['launches_per_call']:g} (torch.profiler; host-inclusive call "
          f"ms {c['ms']:.4f}) | {card}", flush=True)

    # 4. camera path, twice from the same frames
    runs = []
    for _ in range(2):
        (err, fv, _, run), lin = linalg_free("4", camera_main_path, dev, card,
                                             frames)
        if err or lin:
            return fail(err or lin)
        runs.append((fv, run))
    fv = runs[0][0]
    w1, w2 = (r["windows"] for _, r in runs)
    differ = [k for k, (a, b) in enumerate(zip(w1, w2))
              if not torch.equal(a, b)]
    print(f"camera path repeated: ATE {runs[0][1]['ate']:.6f} m and "
          f"{runs[1][1]['ate']:.6f} m (the JAX package on the same drive: "
          f"{JAX_CAMERA_ATE:.6f} m; the port on the CPU, drawing JAX's "
          f"noise, {PORT_CPU_ATE:.6f} m; printed, not gated); windows "
          + (f"first differ at fused tick {differ[0] + 1} of {len(w1)}"
             if differ else f"identical over all {len(w1)} fused ticks"),
          flush=True)
    # kernels C and L on the final (real) window against their plain versions
    from ground_fusion2_tpu_torch.vio.feature_window import to_factor_table
    zero = torch.zeros(fv.layout.dim, device=dev)
    st = fv.carry.state
    real = {
        "proj_normal": checks.check_proj(dev, st, to_factor_table(fv.carry.fw),
                                         fv.layout, zero, vcfg.proj_sqrt_info,
                                         timed=False),
        "small_normal": checks.check_small_normal(
            dev, st, checks.carry_measurements(fv), fv.layout, zero, vcfg,
            timed=False),
    }
    for name, r in real.items():
        print(f"kernel {name} on the final window: " + json.dumps(r),
              flush=True)
    if not all(r["ok"] for r in real.values()):
        return fail("kernel C or L disagrees on the final window")

    # 5. LiDAR path, then kernel Y: the ESKF's innovation inverse, CT-ICP's
    # damped solve and degeneracy test on the next scan's inputs, and the
    # square-root informations of phase 4's final window
    (err, _, lo, next_scan), lin = linalg_free("5", lidar_main_path, dev, card)
    if err or lin:
        return fail(err or lin)
    from ground_fusion2_tpu_torch.lio import ct_icp as ci
    from ground_fusion2_tpu_torch.lio.voxel_map import radix_plan
    x = checks.lio_kernel_inputs(lo, next_scan)
    lcfg = lo.cfg
    icp = lcfg.icp_cfg
    H12, g12, _ = ci.normal_equations(x["pose"], x["pose"], x["kp"], x["ka"],
                                      x["centroid"], x["normal"], x["w"], icp)
    res_y = checks.check_small_linalg(
        dev, checks.sqrt_info_inputs(fv), checks.eskf_innovation(lo), H12, g12,
        icp.damping, x["normal"], x["w"], icp)
    if report(res_y):
        return 1
    res.update(res_y)

    # 6. LiDAR kernels vs plain on the map the drive filled
    res_lio = {
        "lio_assoc": checks.check_assoc(dev, x, lcfg.map_cfg, lcfg.icp_cfg),
        "ct_icp_normal": checks.check_ct_normal(dev, x, lcfg.icp_cfg),
        "ct_icp_solve": checks.check_ct_solve(dev, x, lcfg.icp_cfg),
        "radix_sort": checks.check_radix(dev, x, lcfg.map_cfg),
        "eskf_predict": checks.check_eskf(dev, x, lcfg.eskf_opt),
        "ct_glue": dict(checks.check_ct_glue(dev, x, lcfg.icp_cfg,
                                             lcfg.map_cfg),
                        folded=checks.check_ct_fold(dev, x, lcfg.icp_cfg,
                                                    lcfg.map_cfg)),
        "voxel_glue": checks.check_voxel_glue(dev, x, lcfg.map_cfg, lcfg),
        "lio_update": checks.check_lio_update(dev, x, lio_rc_thresh(lo)),
    }
    ak = res_lio["ct_glue"]
    ak["ok"] = ak["ok"] and ak["folded"]["ok"]
    if report(res_lio):
        return 1
    res.update(res_lio)
    f = ak["folded"]
    print(f"kernel AK folded into D and E on phase 5's "
          f"{x['kp'].shape[0]} keypoints, device ms a call: D's CT-ICP entry "
          f"(cached mode) {f['d_device_ms']:.4f} in {f['d_launches']:g} "
          f"launches against AK points + D + AK weights "
          f"{f['d_replaced_device_ms']:.4f} in {f['d_replaced_launches']:g}; "
          f"E with the solve and the step {f['e_device_ms']:.4f} in "
          f"{f['e_launches']:g} against E with the solve + AK step "
          f"{f['e_replaced_device_ms']:.4f} in {f['e_replaced_launches']:g} "
          f"(in turns); every output equal at Q = {list(checks.FOLD_QUERIES)} "
          f"and in each step case: {f['ok']} | {card}", flush=True)
    d, e = res_lio["lio_assoc"], res_lio["ct_icp_normal"]
    print(f"kernel D (lio_assoc) on phase 5's {x['p_w'].shape[0]} keypoints, "
          f"device ms a call: search mode {d['device_ms']:.4f}, cached mode "
          f"{d['cached_device_ms']:.4f} (query 3 cm off the gather point), "
          f"launches a call {d['launches_per_call']:g} / "
          f"{d['cached_launches_per_call']:g}, the modes' outputs equal: "
          f"{d['modes_equal']}; kernel E (ct_icp_normal) on its "
          f"association: {e['device_ms']:.4f}, launches a call "
          f"{e['launches_per_call']:g} (torch.profiler; host-inclusive call "
          f"ms {d['ms']:.4f} / {d['cached_ms']:.4f} / {e['ms']:.4f}) | {card}",
          flush=True)
    c = res_lio["ct_icp_solve"]
    print(f"kernel E with kernel Y's solve in its last CTA (as CT-ICP "
          f"launches it) on phase 5's association: device ms a call "
          f"{c['device_ms']:.4f} in {c['launches_per_call']:g} launches, E "
          f"without the solve {c['without_solve_device_ms']:.4f}, Y's "
          f"standalone solve {c['icp_solve_device_ms']:.4f} (in turns; "
          f"host-inclusive call ms {c['ms']:.4f} / "
          f"{c['without_solve_ms']:.4f}); H, g, cost equal to E's without "
          f"the solve: {c['normal_equal']}, d equal to Y's standalone: "
          f"{c['standalone_equal']}, d against float64 {c['rel_err_f64']:.3g} "
          f"(the plain LU {c['plain_rel_err_f64']:.3g}); kernel G "
          f"(eskf_predict): device ms a call {res_lio['eskf_predict']['device_ms']:.4f}, "
          f"launches a call {res_lio['eskf_predict']['launches_per_call']:g}, "
          f"{res_lio['eskf_predict']['n_samples']} valid samples | {card}",
          flush=True)
    print("kernel F against torch.sort(stable=True), device ms a call in "
          "turns (F, sort, sort, F) and launches a call, by size: "
          + json.dumps({k: {n: v[n] for n in (
              "device_ms", "library_device_ms", "launches_per_call",
              "library_launches_per_call")}
              for k, v in res_lio["radix_sort"]["sizes"].items()})
          + f" | {card}", flush=True)
    print("kernel F's launch shape, by size (CTAs G, keys a tile S, tiles a "
          "CTA T, the card's co-resident CTAs): " + json.dumps({
              k: radix_plan(_kernels.library(), keys.numel(), bits)
              for k, (keys, bits) in checks.radix_sizes(
                  x, dev, lcfg.map_cfg).items()}), flush=True)

    # 7. camera kernels H-K vs plain, kernel O at the capacity tier
    from ground_fusion2_tpu_torch.vio.state import NUM_FRAMES
    tcfg = cfg.tracker
    tracks = checks.klt_tracks(dev, frames[12:14], F=tcfg.num_slots,
                               cell=tcfg.cell, half=tcfg.half_patch,
                               iters=tcfg.iters, fb=tcfg.fb_thresh)
    res_hk = {
        "preint": checks.check_preint(dev, checks.preint_inputs(
            fv.carry, fv.statics, cfg.estimator.imu_noise,
            cfg.estimator.wheel_noise, NUM_FRAMES - 1)),
        **checks.check_pyramid(dev, frames[12]),
        "detect_grid": checks.check_detect(dev, tracks, cell=tcfg.cell,
                                           F=tcfg.num_slots,
                                           min_response=tcfg.min_response),
        "ransac_f": checks.check_ransac(
            dev, Pinhole.create(*cfg.intrinsics), tracks,
            tcfg.f_thresh_px / tcfg.focal),
    }
    if report(res_hk):
        return 1
    res.update(res_hk)
    c = res["ransac_f"]
    print(f"kernel K (ransac_f) on frames 12 -> 13's tracks "
          f"({c['n_valid']} valid, 64 hypotheses): device ms a call "
          f"{c['device_ms']:.4f}, launches a call {c['launches_per_call']:g}; "
          f"Jacobi sweeps a hypothesis {json.dumps(c['sweeps'])} | {card}",
          flush=True)
    tier_args = checks.ring_graph_args(500, 512, dev)
    tier = checks.check_pg_normal(dev, tier_args)
    print("kernel pg_normal at the 4·512 tier (500 nodes, 8 loops): "
          + json.dumps(tier) + f" | {card}", flush=True)
    if not tier["ok"]:
        return fail("kernel O disagrees at the 4·512 tier")
    from ground_fusion2_tpu_torch.posegraph import pose_graph as pgm
    res_w = {}
    for n, cap in ((60, 64), (500, 512)):
        args = checks.ring_graph_args(n, cap, dev)
        Hp, gp, _ = pgm.pg_normal_equations(*args,
                                            torch.zeros(4 * cap, device=dev))
        res_w[f"chol_solve at 4·{cap}"] = checks.check_chol_solve(
            dev, Hp, gp, checks.pg_free_mask(n, cap, 4, dev))
    if report(res_w):
        return 1
    res["chol_solve"]["sizes"] = {r["n"]: {k: r[k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "rel_err_f64", "tol",
        "device_ms", "library_device_ms", "launches_per_call")}
        for r in (res["chol_solve"], *res_w.values())}
    res_w = window_stage_checks(dev, fv)
    res_w["pg_cost"] = checks.check_pg_cost(dev, tier_args)
    if report(res_w):
        return 1
    res.update(res_w)

    # 8. the system
    t0 = time.perf_counter()
    sys_frames = checks.system_drive(SYS_FRAMES)
    print(f"system drive: {SYS_FRAMES} frames rendered and scanned in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    (err, launches, sys_median, sys_gf), lin = linalg_free(
        "8", system_main_path, dev, card, sys_frames)
    if err or lin:
        return fail(err or lin)

    # 8b. the tick's glue kernels AH, AI, AJ, AN, AO against their plain
    # routes, the slide chosen on the device
    res_glue = glue_checks(dev, frames, sys_gf, sys_frames[-1])
    if report(res_glue):
        return 1
    slide = res_glue.pop("device_slide")
    print("the slide chosen on the device (phase 8's final window): each "
          "marginalization's device ms and activities on its branch and "
          "skipped (its kernels leaving at once, the cuBLAS products on "
          "unwritten buffers; torch.profiler) "
          + json.dumps(slide["branches"]) + "; chosen on the device equal "
          "to the host's choice " + json.dumps(slide["chosen"])
          + "; predicated kernels off their branch "
          + json.dumps(slide["predicated"]) + f" | {card}", flush=True)
    fold = res_glue.pop("preint_lm_fold")
    print("kernel H with Y's square-root informations and kernel S with AN's "
          "step (phase 8's final window) against H then Y and S then AN, "
          "bit for bit, with device ms and launches a call: "
          + json.dumps(fold) + f" | {card}", flush=True)
    res.update(res_glue)

    # 9. the loop-closure path, then M-O against their plain versions on
    # the phase's data
    (err, loop_launches, gf, drive), lin = linalg_free("9", loop_main_path,
                                                       dev, card)
    if err or lin:
        return fail(err or lin)
    launches.update({k: loop_launches.get(k, 0) for k in LOOP_KERNELS})
    loop_draws = loop_launches.get("threefry", 0)
    print(f"phase 9: kernel AQ's split mode (the loop hypotheses' noise, "
          f"JAX's split keys) launched {loop_draws} times over the drive "
          f"| {card}", flush=True)
    if loop_draws == 0:
        return fail("kernel AQ never drew the loop geometry's noise")
    pg = gf.pg
    j, i = pg.loops[-1][:2]
    fx, fy, cx, cy = checks.M3DGR_INTRINSICS
    uv = pg.pts_norm[i] * [fx, fy] + [cx, cy]
    res_loop = checks.check_brief(dev, drive[i]["gray"], uv, pg.desc_valid[i],
                                  pg.desc[j])
    idx_i, idx_j = pg.match(i, j)
    res_loop["loop_geom"] = checks.check_loop_geom(
        dev, pg.loop_inputs(i, j, idx_i, idx_j), pg.cfg.inlier_thresh,
        pg._gumbel(i, j))
    res_loop["pg_normal"] = checks.check_pg_normal(dev,
                                                   checks.pg_normal_args(pg))
    pg_args = checks.pg_normal_args(pg)
    cap = pg_args[0].shape[0]          # the graph's tier
    Hl, gl, _ = pgm.pg_normal_equations(*pg_args,
                                        torch.zeros(4 * cap, device=dev))
    w_loop = checks.check_chol_solve(dev, Hl, gl,
                                     checks.pg_free_mask(pg.n, cap, 4, dev),
                                     timed=False)
    print(f"kernel chol_solve on the loop drive's graph (4·{cap}): "
          + json.dumps(w_loop) + f" | {card}", flush=True)
    if report(res_loop):
        return 1
    if not w_loop["ok"]:
        return fail("kernel W disagrees on the loop drive's graph")
    res.update(res_loop)

    # 10. GNSS + global fusion
    (err, gnss_launches, gf), lin = linalg_free("10", gnss_main_path, dev,
                                                card)
    if err or lin:
        return fail(err or lin)
    launches.update({k: gnss_launches.get(k, 0) for k in GNSS_KERNELS})
    graph = gf.gfusion.graph.to(dev)
    from ground_fusion2_tpu_torch.gnss import global_opt as go
    Hg, gg = go.graph_normal_equations(graph, torch.zeros(
        graph.p.shape[0] * 6, device=dev))[:2]
    w_global = checks.check_chol_solve(
        dev, Hg, gg, graph.node_valid.repeat_interleave(6))
    print(f"kernel chol_solve on the global graph ({Hg.shape[0]}): "
          + json.dumps(w_global) + f" | {card}", flush=True)
    if not w_global["ok"]:
        return fail("kernel W disagrees on the global graph")
    res["chol_solve"]["sizes"][Hg.shape[0]] = {k: w_global[k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "rel_err_f64", "tol",
        "device_ms", "library_device_ms", "launches_per_call")}
    err, lin = linalg_free("10b", gnss_refresh_path, dev, card)
    if err or lin:
        return fail(err or lin)

    # 11. the dynamic mask
    (err, dyn_launches, pair), lin = linalg_free("11", dynamic_main_path, dev,
                                                 card)
    if err or lin:
        return fail(err or lin)
    launches["dyn_mask"] = dyn_launches.get("dyn_mask", 0)

    # 12. P, Q, R against their plain versions on phases 10 and 11's data
    fv = gf.vio
    gcfg = fv.cfg.vio
    gmeas = checks.carry_measurements(fv)
    live = checks.small_normal_live(gmeas, fv.layout, gcfg)
    if not (float(gmeas.gnss_enabled) == 1.0 and live["gnss_psr"] > 0):
        return fail("the final GNSS window has no live GNSS row to hold P on "
                    f"(gnss_enabled {float(gmeas.gnss_enabled)}, {live})")
    res_pqr = {
        "gnss_normal": checks.check_small_normal(
            dev, fv.carry.state, gmeas, fv.layout,
            torch.zeros(fv.layout.dim, device=dev), gcfg),
        "global_normal": checks.check_global_normal(
            dev, gf.gfusion.graph.to(dev)),
        "dyn_mask": checks.check_dyn_mask(dev, pair),
        "global_cost": checks.check_global_cost(dev, gf.gfusion.graph.to(dev)),
    }
    zero = torch.zeros(fv.layout.dim, device=dev)
    st = fv.carry.state
    from ground_fusion2_tpu_torch.vio.problem import window_normal_equations
    H0, g0, _ = window_normal_equations(st, gmeas, fv.layout, gcfg, zero)
    step = _solve_damped(H0, g0, torch.full((), 1e-4, device=dev),
                         torch.ones(fv.layout.dim, device=dev))
    s_gnss = checks.check_window_cost(dev, st, gmeas, fv.layout, gcfg,
                                      dict(zero=zero, step=step))
    print("kernel window_cost on the final GNSS window: " + json.dumps(s_gnss)
          + f" | {card}", flush=True)
    if not s_gnss["ok"]:
        return fail("kernel S disagrees on the final GNSS window")
    res_pqr["sym_eig on the final GNSS window"] = checks.check_sym_eig(
        dev, checks.marg_systems(st, gmeas, fv.layout, gcfg))
    res_pqr["chol_solve on the final GNSS window"] = checks.check_chol_solve(
        dev, H0, g0, timed=False)
    if report(res_pqr):
        return 1
    res.update(res_pqr)

    # 13. the occupancy grid on phase 8's drive
    (err, grid_launches, res["occupancy"]), lin = linalg_free(
        "13", occupancy_main_path, dev, card, sys_frames, sys_median)
    if err or lin:
        return fail(err or lin)
    launches["occupancy"] = grid_launches.get("occupancy", 0)

    # 14. the online mesh on phase 8's drive
    (err, mesh_launches, res_mesh), lin = linalg_free(
        "14", mesh_main_path, dev, card, sys_frames, sys_median)
    if err or lin:
        return fail(err or lin)
    launches.update({k: mesh_launches.get(k, 0) for k in MESH_KERNELS})
    res.update(res_mesh)

    # 15. the line path on phase 3's frames, then AD, AE and B on the last
    # pair
    (err, line_launches, last), lin = linalg_free(
        "15", lines_main_path, dev, card, frames)
    if err or lin:
        return fail(err or lin)
    launches.update({k: line_launches.get(k, 0) for k in LINE_KERNELS})
    res_lines = line_checks(dev, last)
    if report(res_lines):
        return 1
    res.update(res_lines)

    # 16. the distributed solves, one rank over NCCL, then AF, AG and W's
    # explicit-diagonal mode
    (err, dist_launches, ctx), lin = linalg_free("16", dist_main_path, dev,
                                                 card)
    if err or lin:
        return fail(err or lin)
    launches.update({k: dist_launches.get(k, 0) for k in DIST_KERNELS})
    res_dist = dist_checks(dev, ctx)
    if report(res_dist):
        return 1
    w384 = res_dist.pop("chol_solve (mapping, explicit diagonal)")
    res["chol_solve"]["sizes"]["384 (explicit diagonal)"] = {
        k: w384[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                             "rel_err_f64", "tol", "device_ms",
                             "library_device_ms", "launches_per_call")}
    res_dist.pop("chol_solve (window, explicit diagonal)")
    res.update(res_dist)

    # 17. the camera models: AH for each, phase 4's drive as a PinholeFull
    err, res_models = camera_models_path(dev, card, frames, w1)
    if err:
        return fail(err)

    # 18. the chessboard calibration: AP, W and AN
    (err, launches["calib_normal"], res["calib_normal"]), lin = linalg_free(
        "18", calib_main_path, dev, card)
    if err or lin:
        return fail(err or lin)

    # 19. the stereo window: C and S's stereo family, the solve and the
    # marginalization with use_stereo
    (err, res_stereo), lin = linalg_free("19", stereo_main_path, dev, card)
    if err or lin:
        return fail(err or lin)
    for name, fam in (("proj_normal", "proj_normal (stereo)"),
                      ("window_cost", "window_cost (stereo)")):
        res[f"{name}_stereo"] = res_stereo[fam]
        launches[f"{name}_stereo"] = res_stereo["solve"]["launches"][name]

    # 20. kernel AQ against its plain route and jax 0.9.0's answers
    res["threefry"] = checks.check_threefry(dev)
    res["threefry"]["loop_launches"] = loop_draws
    print("kernel threefry (AQ): " + json.dumps(res["threefry"])
          + f" | {card}", flush=True)
    if report({"threefry": res["threefry"]}):
        return 1

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms", "library_device_ms",
            "launches_per_call")
    # launches: phase 8 for A-L, S-Y, AH-AO and AQ, 9 for M-O, 10 for P and
    # Q, 11 for R, 13 for Z, 14 for AA-AC, 15 for AD-AE, 16 for AF-AG, 18
    # for AP, 19 for C's and S's stereo family
    kernels = [dict(name=n, route="cuda", source=PKG + SOURCES[n][0],
                    replaces=SOURCES[n][1], launches=launches.get(n, 0),
                    **{k: res[n][k] for k in keys}) for n in SOURCES]
    # Y's damped solve runs inside E on the path (its standalone launch
    # serves the checks): where its device code is, and E's launches that
    # ran it
    next(k for k in kernels if k["name"] == "icp_solve").update(
        device_code=PKG + "icp_solve_warp.cuh", runs_inside="ct_icp_normal",
        inside_launches=launches.get("ct_icp_solve", 0))
    # Y's square-root informations run inside H's blocks on the path, AN's
    # step inside S's last CTA (their standalone launches serve the checks
    # and the calibration's LM)
    next(k for k in kernels if k["name"] == "sqrt_info").update(
        device_code=PKG + "spd_warp_reg.cuh", runs_inside="preint",
        inside_launches=launches.get("preint_sqrt_info", 0))
    next(k for k in kernels if k["name"] == "lm_glue").update(
        step_device_code=PKG + "lm_step.cuh", step_runs_inside="window_cost",
        step_inside_launches=launches.get("window_cost_step", 0))
    # the GNSS rows P was held on: live pseudorange, Doppler and clock rows
    next(k for k in kernels if k["name"] == "gnss_normal")[
        "gnss_live_rows"] = 2 * live["gnss_psr"] + 5 * live["gnss_clock"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
