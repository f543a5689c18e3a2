"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card, at the main paths' shapes (the comparisons of ``chip_smoke.py``: the
camera kernels A–C and H–L, the LiDAR kernels D–G on a map filled by 12
scans of the bench_lio drive at the M3DGR LIO configuration, the
loop-closure kernels M–O, the GNSS rows P, the global graph Q, the
dynamic mask R, the window cost S, the feature-window stages T–V, the
damped Cholesky W, the eigensolver X, the small solves Y, the occupancy
grid Z, the mesh's insert pass AA, texturing AB and retriangulation AC on a
store filled from a synthetic room cloud, O's and Q's cost-only modes, the
line path's AD and AE on a room frame pair, the distributed solves' AF and
AG and W's explicit-diagonal mode), and C, L, O, P, Q, S–Y and AA–AG
giving the same bits twice; L and P's launches a linearization, and AC over
any number of voxels in one launch (1 to 10,000), bit-equal to launches of
32; H with no valid sample, one and all 128, at other buffer shapes and
propagating alone, B at the image border, on levels smaller than its
window and at half 12, each one launch a call; K at kMaxF (and refusing
one more), at 11 and 12 valid, on tied draws
and near-degenerate samples, and S with the prior off and after another
window's call, each one launch a call; D in its search, cached and flag
modes (equal to each other, following handed-in ranges, at 1 and 4,096
queries, on voxel runs past gather_k and on an empty map) and E at 1 to
8,192 rows, with every weight 0, after a call of another size and on two
streams, each one launch a call; the camera tick's glue AH (the tracker's
tail), AI (the carry's writes and slides), AJ (the marginalization
around X), AN (the LM loop's pack, step, retraction and weigh; L's reduce
adding C's block) and AO (the tick's own ops) bit for bit, with their
launches a fused tick and the window solve's; the slide chosen on the
device equal to the host's choice in both branches, and each predicated
kernel (AN's pack and weigh, C, L, X, AJ) leaving its sentinel-filled
outputs untouched off its branch; the LiDAR tick's
glue AK (CT-ICP's points, weights and step), AL (the keypoint and map
glue around F) and AM (the observations, the select, the switch) bit for
bit, AM through every switch branch, with their launches a LiDAR tick; AK
folded into D's CT-ICP entry (at 1, 33, 2,000 and 2,048 keypoints) and E's
step tail bit for bit its standalone modes; U at 1, 150 and 257 tracks; the mesh and the
grid on the card equal to their plain routes on the same sweeps; AH's lift
and tail for every camera model bit for bit; AP (the calibration's normal
equations and cost) against jacfwd + JᵀJ at δ = 0 and at a seeded δ, and a
whole calibration on the card meeting the truth gates; AQ (JAX's threefry
draws) bit for bit its plain route and jax 0.9.0's answers, one launch a
draw; C and S's stereo family on the stereo window and its solve; the
camera tick's folded conversions (AO's unpack, U's flags, H's sum_dt in
torch's order, Y reading H's covariances in place); Y's square-root
informations folded into H's blocks (H then Y's bits, on a window with no
valid sample in an interval and on a covariance that is not positive
definite), Y's register form at n = 15 and 6 (and its inverse mode, AM's)
against the plain route and float64, and AN's step folded into S's last
CTA (S then AN's bits, mono and stereo, through an accept, a reject, a
tie, a NaN cost and λ at each clamp); V in every mode and T on
``checks.edge_window``'s windows (one track and 37, 3 and 16 frames), and
V's entry refusing outputs that overlap its inputs.
Marked ``cuda``; skipped without a GPU. This file imports no JAX, so it runs
on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import pytest
import torch

from ground_fusion2_tpu_torch import _kernels, checks
from ground_fusion2_tpu_torch.config import m3dgr_lio

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def frames():
    return checks.room_drive(2)


@pytest.fixture(scope="module")
def camera(dev):
    """The M3DGR camera path after 14 frames: the fused carry, and the
    KLT tracks of frames 12 -> 13."""
    import numpy as np
    from ground_fusion2_tpu_torch.config import m3dgr_camera
    from ground_fusion2_tpu_torch.core.cameras import Pinhole
    from ground_fusion2_tpu_torch.vio.fused import FusedVio
    cfg = m3dgr_camera()
    fs = checks.room_drive(14)
    fv = FusedVio(cfg.estimator, cfg.tracker, Pinhole.create(*cfg.intrinsics),
                  dev, tic=np.zeros(3), ric=checks.RIG_RIC, tio=np.zeros(3),
                  rio=np.eye(3), depth_stride=2)
    for f in fs:
        fv.process_image(f["t"], f["gray"], f["depth"], f["imu"],
                         wheel_vel=f["wheel"])
    assert fv.carry is not None
    return cfg, fv, fs, checks.klt_tracks(dev, fs[12:14])


@pytest.fixture(scope="module")
def lio(dev):
    """An odometry on the card after 12 scans, and the kernels' inputs on
    the 13th."""
    from ground_fusion2_tpu_torch.lio.odometry import LidarOdometry
    scans = checks.lidar_drive(13, z=1.0)
    lo = LidarOdometry(m3dgr_lio(), device=dev)
    for s in scans[:12]:
        lo.process_scan(s["t"], s["pts"], s["alpha"], s["valid"], s["imu"])
    return lo, scans[12], checks.lio_kernel_inputs(lo, scans[12])


def test_clahe_kernel_matches_plain(dev, frames):
    r = checks.check_clahe(dev, frames[0])
    assert r["ok"], r


def test_klt_kernel_matches_plain(dev, frames):
    r = checks.check_klt(dev, frames)
    assert r["ok"], r
    assert r["n_tracked"] > 50


def test_proj_normal_kernel_matches_plain(dev):
    r = checks.check_proj(dev, timed=False)
    assert r["ok"], r


def test_lio_assoc_kernel_matches_plain(dev, lio):
    lo, _, x = lio
    r = checks.check_assoc(dev, x, lo.cfg.map_cfg, lo.cfg.icp_cfg)
    assert r["ok"], r
    assert r["n_planar"] > 500


def test_ct_icp_normal_kernel_matches_plain(dev, lio):
    lo, _, x = lio
    r = checks.check_ct_normal(dev, x, lo.cfg.icp_cfg)
    assert r["ok"], r


def _assoc_call(x, p_g, p_q, ranges, search):
    from ground_fusion2_tpu_torch.lio import voxel_map as vm
    return vm.associate(x["vmap"], p_g, p_q, m3dgr_lio().map_cfg, ranges,
                        search)


def _ranges(dev, Q):
    return torch.empty((Q, 27), dtype=torch.int32, device=dev)


def test_lio_assoc_kernel_modes_are_equal(dev, lio):
    """Search, cached, and the flag set or clear: the same four outputs."""
    _, _, x = lio
    p_g, p_q = checks.assoc_points(dev, x)
    r = _ranges(dev, p_q.shape[0])
    want = _assoc_call(x, p_g, p_q, r, True)
    for search in (False, torch.tensor(True, device=dev),
                   torch.tensor(False, device=dev)):
        got = _assoc_call(x, p_g, p_q, r, search)
        for a, b in zip(got, want):
            assert torch.equal(a, b), search


def test_lio_assoc_kernel_follows_the_ranges_with_the_flag_clear(dev, lio):
    """Ranges searched around another gather point (0.5 m off): with the
    flag clear the outputs are that gather's, with it set the query's own."""
    from ground_fusion2_tpu_torch.lio import voxel_map as vm
    lo, _, x = lio
    cfg = lo.cfg
    p_g, p_q = checks.assoc_points(dev, x)
    other = p_g + torch.tensor([0.5, 0.0, 0.0], device=dev)
    r = _ranges(dev, p_q.shape[0])
    want = _assoc_call(x, other, p_q, r, True)
    got = _assoc_call(x, p_q, p_q, r, torch.tensor(False, device=dev))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    e = checks.assoc_errors(got, vm.associate_plain(x["vmap"], other, p_q,
                                                    cfg.map_cfg),
                            p_q, cfg.icp_cfg)
    assert e["ok"], e
    got = _assoc_call(x, p_q, p_q, r, torch.tensor(True, device=dev))
    e = checks.assoc_errors(got, vm.associate_plain(x["vmap"], p_q, p_q,
                                                    cfg.map_cfg),
                            p_q, cfg.icp_cfg)
    assert e["ok"], e
    assert torch.equal(r, vm.gather_ranges_plain(x["vmap"], p_q, cfg.map_cfg))


@pytest.mark.parametrize("Q", [1, 4096])
def test_lio_assoc_kernel_at_any_query_count(dev, lio, Q):
    from ground_fusion2_tpu_torch.lio import voxel_map as vm
    lo, _, x = lio
    cfg = lo.cfg
    p_g, p_q = checks.assoc_points(dev, x)
    reps = -(-Q // p_g.shape[0])
    shift = torch.arange(reps, device=dev).repeat_interleave(p_g.shape[0])
    shift = (shift[:, None] * torch.tensor([0.07, 0.0, 0.0], device=dev))[:Q]
    p_g, p_q = p_g.repeat(reps, 1)[:Q] + shift, p_q.repeat(reps, 1)[:Q] + shift
    r = _ranges(dev, Q)
    new = _assoc_call(x, p_g, p_q, r, True)
    e = checks.assoc_errors(new, vm.associate_plain(x["vmap"], p_g, p_q,
                                                    cfg.map_cfg),
                            p_q, cfg.icp_cfg)
    assert e["ok"], e
    for a, b in zip(_assoc_call(x, None, p_q, r, False), new):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["dense", "empty"])
def test_lio_assoc_kernel_on_long_runs_and_an_empty_map(dev, case):
    """A map whose voxels hold up to max_per_voxel points (runs longer than
    gather_k), and a map of INVALID codes only (no candidate anywhere)."""
    from ground_fusion2_tpu_torch.lio import voxel_map as vm
    cfg = m3dgr_lio()
    mcfg = cfg.map_cfg
    g = torch.Generator().manual_seed(4)
    cube = (torch.rand((40_000, 3), generator=g) * 2.0).to(dev)
    vmap = vm.VoxelMap.empty(mcfg, dev)
    if case == "dense":
        vmap = vm.insert(vmap, cube, torch.ones(cube.shape[0], device=dev),
                         mcfg)
        runs = torch.unique_consecutive(vmap.code[vmap.code != vm.INVALID],
                                        return_counts=True)[1]
        assert int(runs.max()) > mcfg.gather_k
    p_g = cube[:2000]
    p_q = p_g + torch.tensor([0.03, -0.02, 0.01], device=dev)
    r = _ranges(dev, 2000)
    new = vm.associate(vmap, p_g, p_q, mcfg, r, True)
    e = checks.assoc_errors(new, vm.associate_plain(vmap, p_g, p_q, mcfg),
                            p_q, cfg.icp_cfg)
    assert e["ok"], e
    assert torch.equal(r, vm.gather_ranges_plain(vmap, p_g, mcfg))
    assert (e["n_valid"] > 1000) if case == "dense" else (e["n_valid"] == 0)
    for a, b in zip(vm.associate(vmap, None, p_q, mcfg, r, False), new):
        assert torch.equal(a, b)


@pytest.mark.parametrize("K,weights", [(1, True), (2000, True),
                                       (8192, True), (2000, False)])
def test_ct_icp_normal_kernel_at_any_row_count(dev, K, weights):
    """K = 1 to 8,192 rows (the scratch grows), and every weight 0."""
    from ground_fusion2_tpu_torch.lio import ct_icp as ci
    args = checks.ct_normal_case(dev, K, weights=weights)
    e = checks.ct_normal_errors(ci.normal_equations(*args),
                                ci.normal_equations_plain(*args))
    assert all(e[k] <= checks.ICP_TOLS[k] for k in e), e


def test_ct_icp_normal_kernel_repeats_after_another_size(dev):
    """The same bits before and after a call at another K: the ticket and
    the scratch are left as the next call needs them."""
    from ground_fusion2_tpu_torch.lio import ct_icp as ci
    args = checks.ct_normal_case(dev, 2000)
    want = ci.normal_equations(*args)
    ci.normal_equations(*checks.ct_normal_case(dev, 8192, seed=1))
    ci.normal_equations(*checks.ct_normal_case(dev, 1, seed=2))
    for a, b in zip(ci.normal_equations(*args), want):
        assert torch.equal(a, b)


def test_ct_icp_normal_kernel_on_two_streams(dev):
    """Calls on two streams at once, each stream with its own ticket and
    scratch: every call's bits equal the same call's made alone."""
    from ground_fusion2_tpu_torch.lio import ct_icp as ci
    cases = [checks.ct_normal_case(dev, 2000, seed=s) for s in range(8)]
    want = [ci.normal_equations(*a) for a in cases]
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    torch.cuda.synchronize()
    got = []
    for i, a in enumerate(cases):
        with torch.cuda.stream(streams[i % 2]):
            got.append(ci.normal_equations(*a))
    torch.cuda.synchronize()
    for g_, w_ in zip(got, want):
        for a, b in zip(g_, w_):
            assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["drive", "K=1", "K=8192"])
def test_ct_icp_solve_in_e_matches_y_and_plain(dev, lio, case):
    """E with Y's solve in its last CTA: H, g and cost the bits of E alone,
    d the bits of Y's standalone launch on them, and d against the plain
    LU, both against float64 (``checks.check_ct_solve``)."""
    lo, _, x = lio
    if case != "drive":
        pose, pred, kp, ka, cen, nrm, w, _ = checks.ct_normal_case(
            dev, int(case[2:]), seed=4)
        x = dict(pose=pose, kp=kp, ka=ka, centroid=cen, normal=nrm, w=w)
    r = checks.check_ct_solve(dev, x, lo.cfg.icp_cfg, timed=False)
    assert r["ok"], r


@pytest.mark.parametrize("call", ["search", "cached", "flag", "E",
                                  "E with the solve"])
def test_lio_kernels_launch_once_a_call(dev, lio, call):
    from ground_fusion2_tpu_torch.lio import ct_icp as ci
    lo, _, x = lio
    p_g, p_q = checks.assoc_points(dev, x)
    r = _ranges(dev, p_q.shape[0])
    _assoc_call(x, p_g, p_q, r, True)
    flag = torch.tensor(True, device=dev)
    args = checks.ct_normal_args(dev, x, lo.cfg.icp_cfg)
    fn, name = {
        "search": (lambda: _assoc_call(x, p_g, p_q, r, True), "lio_assoc"),
        "cached": (lambda: _assoc_call(x, None, p_q, r, False), "lio_assoc"),
        "flag": (lambda: _assoc_call(x, p_g, p_q, r, flag), "lio_assoc"),
        "E": (lambda: ci.normal_equations(*args), "ct_icp_normal"),
        "E with the solve": (lambda: ci.normal_solve(*args),
                             "ct_icp_solve")}[call]
    _kernels.launches.clear()
    dt = checks.device_ms(fn)
    assert dt.launches == 1, dt
    assert _kernels.launches[name] == dt.calls, (dict(_kernels.launches), dt)


def test_radix_sort_kernel_matches_plain(dev, lio):
    lo, _, x = lio
    r = checks.check_radix(dev, x, lo.cfg.map_cfg, timed=False)
    assert r["ok"], r


@pytest.mark.parametrize("n", [64, 4097, 69_632, 131_072, 135_168])
@pytest.mark.parametrize("family", checks.RADIX_FAMILIES)
def test_radix_sort_kernel_order_equals_torch_sort(dev, family, n):
    """Kernel F's order is torch.sort(stable=True)'s, index for index, on
    each key family at the main path's sizes and off a chunk's edge."""
    from ground_fusion2_tpu_torch.lio import voxel_map as vm
    keys, bits = checks.radix_key_families(n, seed=n)[family]
    k = torch.as_tensor(keys, device=dev)
    got = vm.stable_argsort(k, bits)
    assert got.dtype == torch.int64
    assert torch.equal(got, torch.sort(k, stable=True).indices)


def _radix_one_tile_limit():
    """Keys kernel F sorts with one tile a CTA: the card's CTAs × 4,096."""
    from ground_fusion2_tpu_torch.lio import voxel_map as vm
    return vm.radix_plan(_kernels.library(), 1, 31)["ctas"] * 4096


@pytest.mark.parametrize("where", ["limit - 1", "limit + 1", "4,000,000"])
@pytest.mark.parametrize("family", ["map_codes", "dist2", "subcells"])
def test_radix_sort_kernel_orders_any_size(dev, family, where):
    """A map of millions of points sorts: one tile a CTA up to the card's
    CTAs × 4,096 keys, then more tiles a CTA; the order is torch.sort's."""
    from ground_fusion2_tpu_torch.lio import voxel_map as vm
    limit = _radix_one_tile_limit()
    n = {"limit - 1": limit - 1, "limit + 1": limit + 1,
         "4,000,000": 4_000_000}[where]
    plan = vm.radix_plan(_kernels.library(), n, 31)
    assert (plan["T"] == 1) == (n <= limit), plan
    keys, bits = checks.radix_key_families(n, seed=3)[family]
    k = torch.as_tensor(keys, device=dev)
    assert torch.equal(vm.stable_argsort(k, bits),
                       torch.sort(k, stable=True).indices)


@pytest.mark.parametrize("n", [1, 4097, 69_632, 135_168, 600_000,
                               1_100_000, 4_000_000])
@pytest.mark.parametrize("bits", [31, 6])
def test_radix_sort_plan_is_the_models(dev, n, bits):
    """gf2_radix_plan's (G, S, T, passes) are the numpy model's
    (tests/torch_radix_model.py) at the card's own CTA count."""
    import torch_radix_model as model
    from ground_fusion2_tpu_torch.lio import voxel_map as vm
    plan = vm.radix_plan(_kernels.library(), n, bits)
    assert (plan["G"], plan["S"], plan["T"], plan["passes"]) == model.plan(
        n, bits, max_ctas=plan["ctas"]), plan


@pytest.mark.parametrize("bits", [31, 6, 1])
def test_radix_sort_kernel_launches_once_a_sort(dev, bits):
    """One launch a sort (at most passes + 1), the wrapper counted once a
    call."""
    from ground_fusion2_tpu_torch.lio import voxel_map as vm
    keys, _ = checks.radix_key_families(135_168)["map_codes"]
    k = torch.as_tensor(keys, device=dev) & ((1 << bits) - 1)
    _kernels.launches.clear()
    t = checks.device_ms(lambda: vm.stable_argsort(k, bits), reps=5)
    passes = vm.radix_plan(_kernels.library(), k.numel(), bits)["passes"]
    assert t.launches <= passes + 1, t
    assert t.launches == 1, t
    assert _kernels.launches["radix_sort"] == t.calls, t


@pytest.mark.parametrize("F", [150, 16])
def test_proj_normal_kernel_matches_plain_and_repeats(dev, F):
    """Kernel C against its plain version within checks.py's tolerances,
    the same bits twice, at F = 150 (D = 396) and at a small window; two
    launches a call and no memset."""
    x0, feats, layout, delta = checks.example_window(F, dev)
    r = checks.check_proj(dev, x0, feats, layout, delta, timed=False)
    assert r["ok"] and r["repeat_equal"], r
    from ground_fusion2_tpu_torch.factors import vio_factors as fac
    t = checks.device_ms(lambda: fac.projection_normal_equations(
        x0, delta, feats, layout, 607.79772949218 / 1.5), reps=5)
    assert t.launches == 2, t
    assert not any(k.startswith("Memset") for k in t.kernels), t


def test_eskf_predict_kernel_matches_plain(dev, lio):
    lo, _, x = lio
    r = checks.check_eskf(dev, x, lo.cfg.eskf_opt)
    assert r["ok"], r


@pytest.mark.parametrize("n_valid", [0, 1, 20, 48])
def test_eskf_predict_kernel_with_gaps(dev, lio, n_valid):
    """Kernel G against its plain version with ``n_valid`` of the 48 slots
    valid at seeded places (gaps between them; the drive's steps, 5 ms in
    the slots past the sweep's samples), the same bits twice; with none
    valid the state comes back unchanged."""
    import numpy as np
    lo, _, x = lio
    m = np.zeros(48, np.float32)
    m[np.random.default_rng(n_valid).choice(48, n_valid, replace=False)] = 1
    smask = torch.as_tensor(m, device=dev)
    dts = torch.where(x["dts"] > 0, x["dts"], torch.full_like(x["dts"], 0.005))
    r = checks.check_eskf(dev, dict(x, smask=smask, dts=dts),
                          lo.cfg.eskf_opt, timed=False)
    assert r["ok"] and r["repeat_equal"] and r["n_samples"] == n_valid, r
    if n_valid == 0:
        from ground_fusion2_tpu_torch.lio import eskf
        s = eskf.predict_final(x["eskf"], x["acc"], x["gyr"], dts, smask,
                               lo.cfg.eskf_opt)
        for a, b in zip(s, x["eskf"]):
            assert torch.equal(a, b)


def test_preint_kernel_matches_plain(dev, camera):
    from ground_fusion2_tpu_torch.vio.state import NUM_FRAMES
    cfg, fv, _, _ = camera
    r = checks.check_preint(dev, checks.preint_inputs(
        fv.carry, fv.statics, cfg.estimator.imu_noise,
        cfg.estimator.wheel_noise, NUM_FRAMES - 1))
    assert r["ok"], r
    assert r["n_samples"] >= 100


def _preint_case(camera, n_valid: int, dt: float = 0.001) -> dict:
    """The fused window's kernel H inputs with each interval's first
    ``n_valid`` slots valid at ``dt`` (0: none; 128: all)."""
    from ground_fusion2_tpu_torch.vio.state import NUM_FRAMES
    cfg, fv, _, _ = camera
    x = checks.preint_inputs(fv.carry, fv.statics, cfg.estimator.imu_noise,
                             cfg.estimator.wheel_noise, NUM_FRAMES - 1)
    args = list(x["args"])
    args[3] = torch.full_like(args[3], dt)
    args[4] = torch.zeros_like(args[4])
    args[4][:, :n_valid] = 1.0
    return dict(args=tuple(args), prop=x["prop"])


def _preint_random(dev, n_int: int, M: int, seed: int = 0) -> dict:
    """Kernel H's inputs at any [n_int, M] from a seed: valid prefixes of
    random length (one interval empty, one full), 1–3 ms samples."""
    import numpy as np
    from ground_fusion2_tpu_torch.config import m3dgr_camera
    from ground_fusion2_tpu_torch.sensors import window_preint as wp
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    e = m3dgr_camera().estimator
    mask = np.zeros((n_int, M), np.float32)
    for i, n in enumerate(rng.integers(0, M + 1, n_int)):
        mask[i, :n] = 1.0
    mask[0], mask[-1] = 0.0, 1.0
    q = rng.normal(size=4)
    q = q / np.linalg.norm(q) * np.sign(q[0])
    args = (t(rng.normal(0, 0.5, (n_int, M + 1, 3))),
            t(rng.normal(0, 0.3, (n_int, M + 1, 3))),
            t(rng.normal(0, 0.5, (n_int, M + 1, 3))),
            t(rng.uniform(0.001, 0.003, (n_int, M))), t(mask),
            t(rng.normal(0, 0.05, (n_int, 3))),
            t(rng.normal(0, 0.01, (n_int, 3))), t(1.02), t(0.97), t(1.01),
            e.imu_noise, e.wheel_noise, t(q))
    prop = wp.Propagate(t(rng.normal(size=3)), t([1.0, 0.0, 0.0, 0.0]),
                        t(rng.normal(size=3)), t(rng.normal(0, 0.05, 3)),
                        t(rng.normal(0, 0.01, 3)), t([0.0, 0.0, -9.81]),
                        n_int - 1)
    return dict(args=args, prop=prop)


@pytest.mark.parametrize("n_valid", [0, 1, 128])
def test_preint_kernel_at_any_valid_count(dev, camera, n_valid):
    """Kernel H with no valid sample, one, and all 128 of every interval:
    the plain loops' results, the folded glue bit for bit."""
    r = checks.check_preint(dev, _preint_case(camera, n_valid), timed=False)
    assert r["ok"], r
    assert r["n_samples"] == n_valid * camera[1].carry.dt.shape[0]


@pytest.mark.parametrize("n_int,M", [(10, 128), (3, 129), (10, 37), (1, 300)])
def test_preint_kernel_at_any_slot_count(dev, n_int, M):
    """Kernel H's intervals at the tick's 128 slots (random valid prefixes,
    tiles past 32 samples, sum_dt in torch's order) and refused at another
    slot count; the propagation alone at every slot count."""
    from ground_fusion2_tpu_torch.sensors import window_preint as wp
    x = _preint_random(dev, n_int, M)
    if M == wp.SUM_SLOTS:
        r = checks.check_preint(dev, x, timed=False)
        assert r["ok"], r
    else:
        with pytest.raises(ValueError, match="slots"):
            wp.preintegrate_window(*x["args"], prop=x["prop"])
    _, _, vk = wp.preintegrate_window(*x["args"], prop=x["prop"],
                                      intervals=False)
    _, _, vp = wp.preintegrate_window_plain(*x["args"], prop=x["prop"],
                                            intervals=False)
    for a, b in zip(vk, vp):
        assert float((a - b).abs().max()) <= checks.PREINT_TOL["delta"]


def _klt_compare(p0, p1, uv, valid, half=10, iters=10, fb=0.8):
    """Kernel B against the plain version on the card: (tracked flags that
    differ, max |Δpts| over the plain version's tracks, tracks)."""
    from ground_fusion2_tpu_torch.frontend import klt
    pk, tk = klt.klt_track(p0, p1, uv, valid, half, iters, fb)
    pp, tp = klt.klt_track_plain(p0, p1, uv, valid, half, iters, fb)
    m = tp > 0
    err = float((pk - pp)[m].abs().max()) if bool(m.any()) else 0.0
    return int((tk != tp).sum()), err, int(m.sum())


@pytest.mark.parametrize("case", ["border", "small levels", "half 12"])
def test_klt_kernel_at_the_border_and_on_small_levels(dev, frames, case):
    """Kernel B with features on and next to the image border, on a
    64×48 frame whose levels are smaller than the window (negative window
    origins), and at half 12 (three taps a parent thread)."""
    from ground_fusion2_tpu_torch.frontend import klt
    p0, p1, uv, valid = checks.klt_inputs(dev, frames)
    half = 12 if case == "half 12" else 10
    if case == "border":
        H, W = p0[0].shape
        edge = torch.tensor([[0.0, 0.0], [0.3, 0.2], [W - 1.0, H - 1.0],
                             [W - 1.4, H - 1.6], [5.0, H / 2], [W / 2, 2.5],
                             [W - 4.0, 100.0], [3.2, H - 3.7]], device=dev)
        uv = torch.cat([edge, uv[:24]])
        valid = torch.ones(uv.shape[0], device=dev)
    elif case == "small levels":
        crop = lambda p: [x.contiguous() for x in klt.build_pyramid(
            p[0][200:248, 300:364].contiguous(), 4)]
        p0, p1 = crop(p0), crop(p1)
        g = torch.Generator().manual_seed(0)
        uv = torch.rand((40, 2), generator=g).to(dev) \
            * torch.tensor([60.0, 44.0], device=dev) + 2.0
        valid = torch.ones(40, device=dev)
    mism, err, n = _klt_compare(p0, p1, uv, valid, half)
    assert mism == 0 and err <= checks.KLT_TOL_PX, (mism, err, n)
    if case != "border":
        assert n > 10


@pytest.mark.parametrize("kernel,activities", [
    ("preint", 1), ("preint alone", 1), ("klt", 1)])
def test_preint_and_klt_activities_a_call(dev, camera, frames, kernel,
                                          activities):
    """CUDA activities a call (the profiler's count): H is its kernel alone,
    with the intervals (sum_dt its own at the tick's 128 slots) and for the
    propagation alone; B is one."""
    from ground_fusion2_tpu_torch.frontend import klt
    from ground_fusion2_tpu_torch.sensors import window_preint as wp
    if kernel.startswith("preint"):
        x = _preint_case(camera, 18)
        fn = lambda: wp.preintegrate_window(
            *x["args"], prop=x["prop"], intervals=kernel == "preint")
    else:
        p0, p1, uv, valid = checks.klt_inputs(dev, frames)
        fn = lambda: klt.klt_track(p0, p1, uv, valid, 10, 10, 0.8)
    t = checks.device_ms(fn, reps=5)
    assert t.launches == activities, t


def test_pyramid_kernels_match_plain(dev, camera):
    r = checks.check_pyramid(dev, camera[2][12])
    assert r["pyramid"]["ok"] and r["shi_tomasi"]["ok"], r


def test_detect_grid_kernel_matches_plain(dev, camera):
    r = checks.check_detect(dev, camera[3])
    assert r["ok"] and r["order_equal"], r


def test_ransac_kernel_matches_plain(dev, camera):
    from ground_fusion2_tpu_torch.core.cameras import Pinhole
    cfg = camera[0]
    r = checks.check_ransac(dev, Pinhole.create(*cfg.intrinsics), camera[3],
                            cfg.tracker.f_thresh_px / cfg.tracker.focal)
    assert r["ok"], r


def test_device_ms_raises_when_the_calls_run_nothing_on_the_card(dev):
    """Three traces with only the markers in them (CPU tensors): a raise,
    no figure."""
    with pytest.raises(RuntimeError, match="no CUDA activity"):
        checks.device_ms(lambda: torch.zeros(3) + 1, reps=3)


def _gumbel(dev, F, seed=12, hypotheses=64):
    from ground_fusion2_tpu_torch.core.prng import gumbel_noise
    return gumbel_noise(seed, hypotheses, F, dev)


@pytest.mark.parametrize("F,n_valid", [(1024, None), (150, 11), (150, 12)])
def test_ransac_kernel_at_kmaxf_and_the_valid_floor(dev, F, n_valid):
    """Kernel K at kMaxF = 1024 correspondences, and at 11 valid (the mask
    comes back unchanged) and 12 (RANSAC runs), against the plain version."""
    p1, p2, valid = checks.ransac_points(dev, F, n_valid)
    r = checks.check_ransac_points(dev, p1, p2, valid, 1.0 / 460.0,
                                   _gumbel(dev, F), timed=False)
    assert r["ok"] and r["sweeps"]["at_cap"] == 0, r
    from ground_fusion2_tpu_torch.frontend import ransac as rs
    keep = rs.ransac_f_reject(p1, p2, valid, _gumbel(dev, F), 1.0 / 460.0)
    if n_valid == 11:
        assert torch.equal(keep, valid)
    else:
        assert bool((keep <= valid).all()) and not torch.equal(keep, valid)


def test_ransac_kernel_refuses_more_than_kmaxf(dev):
    from ground_fusion2_tpu_torch.frontend import ransac as rs
    p1, p2, valid = checks.ransac_points(dev, 1025)
    with pytest.raises(RuntimeError, match="gf2_ransac_f"):
        rs.ransac_f_cuda(p1, p2, valid, _gumbel(dev, 1025), 1.0 / 460.0)


def test_ransac_kernel_takes_the_lower_index_on_tied_g(dev):
    """Gumbel noise rounded to 0.5 ties most slots: each hypothesis's 8
    samples are the largest g, the lower index first (lax.top_k's order);
    its F against the plain 8-point solve on those samples in float64."""
    import numpy as np
    from ground_fusion2_tpu_torch.frontend import ransac as rs
    p1, p2, valid = checks.ransac_points(dev, 150)
    g = torch.round(_gumbel(dev, 150) * 2.0) / 2.0
    out = rs.ransac_f_cuda(p1, p2, valid, g, 1.0 / 460.0)
    gn = g.cpu().numpy()
    idx = torch.as_tensor(np.stack([np.lexsort((np.arange(150), -row))[:8]
                                    for row in gn]), device=dev)
    d64 = lambda t: t.to(torch.float64)
    want = rs._eight_point(d64(p1)[idx], d64(p2)[idx])
    err = float((checks._unit_sign(out["Fs"])
                 - checks._unit_sign(want)).abs().max())
    assert err <= checks.RANSAC_F_TOL, err


def test_ransac_kernel_on_near_degenerate_samples(dev):
    """Every point within 1e-6 of one image line: each hypothesis's null
    space has several dimensions; the kernel ends, finite, within the cap."""
    from ground_fusion2_tpu_torch.frontend import ransac as rs
    p1, p2, valid = checks.ransac_points(dev, 150, line=True)
    out = rs.ransac_f_cuda(p1, p2, valid, _gumbel(dev, 150), 1.0 / 460.0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out["Fs"]).all()), out["Fs"]
    assert int(out["sweeps"].max()) < rs.SWEEP_CAP, out["sweeps"]


def test_ransac_kernel_on_two_streams(dev):
    """Calls on two streams at once, each stream with its own ticket: every
    call's best, keep and counts equal the same call's made alone."""
    from ground_fusion2_tpu_torch.frontend import ransac as rs
    p1, p2, valid = checks.ransac_points(dev, 1024)
    gs = [_gumbel(dev, 1024, seed=s) for s in range(8)]
    want = [rs.ransac_f_cuda(p1, p2, valid, g, 1.0 / 460.0) for g in gs]
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    torch.cuda.synchronize()
    got = []
    for i, g in enumerate(gs):
        with torch.cuda.stream(streams[i % 2]):
            got.append(rs.ransac_f_cuda(p1, p2, valid, g, 1.0 / 460.0))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        for key in ("best", "keep", "counts"):
            assert torch.equal(a[key], b[key]), (key, a[key], b[key])


def test_ransac_kernel_launches_once_a_call(dev):
    from ground_fusion2_tpu_torch.frontend import ransac as rs
    p1, p2, valid = checks.ransac_points(dev, 150)
    g = _gumbel(dev, 150)
    _kernels.launches.clear()
    dt = checks.device_ms(lambda: rs.ransac_f_reject(p1, p2, valid, g,
                                                     1.0 / 460.0))
    assert dt.launches == 1, dt
    assert _kernels.launches["ransac_f"] == dt.calls, (
        dict(_kernels.launches), dt)


@pytest.fixture(scope="module")
def window(dev):
    """The example window at F = 150 (D = 396) with its measurements."""
    from ground_fusion2_tpu_torch.config import m3dgr_camera
    x0, feats, layout, delta = checks.example_window(150, dev)
    meas = checks.example_measurements(x0, feats, layout, dev)
    return x0, feats, layout, delta, meas, m3dgr_camera().estimator.vio


def test_small_normal_kernel_matches_plain(dev, window):
    x0, _, layout, delta, meas, vcfg = window
    r = checks.check_small_normal(dev, x0, meas, layout, delta, vcfg,
                                  timed=False)
    assert r["ok"] and r["repeat_equal"], r


def test_small_normal_kernel_on_a_fused_window(dev, camera):
    cfg, fv, _, _ = camera
    zero = torch.zeros(fv.layout.dim, device=dev)
    r = checks.check_small_normal(dev, fv.carry.state,
                                  checks.carry_measurements(fv), fv.layout,
                                  zero, cfg.estimator.vio, timed=False)
    assert r["ok"], r


@pytest.mark.parametrize("case", ["enabled", "disabled", "empty"])
def test_gnss_normal_kernel_matches_plain(dev, window, case):
    """Kernel P (the GNSS rows, in kernel L's launch) at the Ground-Challenge
    GNSS configuration's widths (F = 150, S = 16) on the example window with
    a simulated sky: with the gate on, off, and over an empty table."""
    from ground_fusion2_tpu_torch.config import groundchallenge_gnss
    from ground_fusion2_tpu_torch.gnss.factors import GnssTable
    x0, _, layout, delta, meas, _ = window
    x, m = checks.example_gnss(x0, meas, layout, dev)
    if case == "disabled":
        m = m._replace(gnss_enabled=torch.zeros((), device=dev))
    elif case == "empty":
        m = m._replace(gnss=GnssTable.empty(layout.W, dev))
    _kernels.launches.clear()
    r = checks.check_small_normal(dev, x, m, layout, delta,
                                  groundchallenge_gnss().estimator.vio,
                                  timed=False)
    assert r["ok"] and r["repeat_equal"], r
    assert _kernels.launches["gnss_normal"] == 2


@pytest.mark.parametrize("gnss", [False, True], ids=["L", "P"])
def test_small_normal_launches_a_call(dev, window, gnss):
    """Kernels L and P in a solve's closure (inputs packed once): a
    linearization is at most 5 CUDA activities (two kernels, the prior's
    three plain products), the wrapper counts one a call, and a second
    call gives the same bits."""
    from ground_fusion2_tpu_torch.config import groundchallenge_gnss
    from ground_fusion2_tpu_torch.factors import vio_factors as fac
    x0, _, layout, delta, meas, vcfg = window
    if gnss:
        x0, meas = checks.example_gnss(x0, meas, layout, dev)
        vcfg = groundchallenge_gnss().estimator.vio
    fn = fac.small_normal_fn(x0, meas, layout, vcfg)
    _kernels.launches.clear()
    dt = checks.device_ms(lambda: fn(delta))
    assert dt.launches <= 5, dt
    assert _kernels.launches["small_normal"] == dt.calls, (
        dict(_kernels.launches), dt)
    a, b = fn(delta), fn(delta)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _global_graph(dev, n=200, cap=256):
    """A GlobalFusion at capacity ``cap`` fed ``n`` keyframes of a drifting
    circle with GPS on every other one and two tag anchors, on the card."""
    import numpy as np
    from ground_fusion2_tpu_torch.gnss.global_opt import GlobalFusion
    rng = np.random.default_rng(0)
    gfu = GlobalFusion(cap, dev)
    for k in range(n):
        th = 0.05 * k
        p = np.array([8 * np.sin(th), 8 * (1 - np.cos(th)), 0.0])
        q = np.array([np.cos(th / 2), 0, 0, np.sin(th / 2)])
        gfu.input_odom(p * 1.02 + [0.002 * k, 0, 0], q)
        if k % 2 == 0:
            gfu.input_gps(gfu.n - 1, p + rng.normal(scale=0.3, size=3), 1.5)
        if k in (40, 160):
            gfu.input_tag_pose(gfu.n - 1, p, q, 0.2)
    return gfu


def test_global_normal_kernel_matches_plain(dev):
    """Kernel Q on a 200-node graph at capacity 256 (H 1536²), twice the
    same bits; then GlobalFusion.optimize on the card."""
    gfu = _global_graph(dev)
    r = checks.check_global_normal(dev, gfu.graph.to(dev))
    assert r["ok"] and r["repeat_equal"], r
    _kernels.launches.clear()
    gfu.optimize()
    assert _kernels.launches["global_normal"] == 7     # 6 iterations + 1


@pytest.mark.parametrize("up", [1, 2])
def test_dyn_mask_kernel_matches_plain(dev, up):
    """Kernel R on frames 10 → 11 of the occluder drive, decimated by 2 to
    320×240 (80×60 cells): the grid mask alone (up 1), and upsampled to
    640×480 and OR-ed into a mask as the fused tick does (up 2)."""
    import numpy as np
    from ground_fusion2_tpu_torch.config import DynMaskConfig
    fs = checks.dynamic_drive(12, n_rays=64)
    lo = lambda f: (
        torch.as_tensor(f["gray"][::2, ::2].astype(np.float32) / 255.0,
                        device=dev),
        torch.as_tensor(np.asarray(f["depth"], np.float32)[::2, ::2],
                        device=dev))
    base = None
    if up == 2:
        base = torch.zeros((480, 640), device=dev)
        base[:16, :16] = 1.0
    K = np.array(checks.M3DGR_INTRINSICS, np.float32) / 2
    x = dict(prev=lo(fs[10]), cur=lo(fs[11]), R_pc=np.eye(3, dtype=np.float32),
             t_pc=np.array([0.0, 0.0, -0.08], np.float32), K=K,
             cfg=DynMaskConfig(), up=up,
             out_hw=(240 * up, 320 * up), base=base)
    r = checks.check_dyn_mask(dev, x)
    assert r["ok"] and r["mask_share"] > 0.0, r


def test_proj_normal_kernel_repeats_bit_for_bit(dev, window):
    x0, feats, layout, delta, _, vcfg = window
    r = checks.check_proj(dev, x0, feats, layout, delta, vcfg.proj_sqrt_info,
                          timed=False)
    assert r["ok"] and r["repeat_equal"], r


def test_brief_kernels_match_plain(dev, frames):
    from ground_fusion2_tpu_torch.frontend import klt
    from ground_fusion2_tpu_torch.posegraph import brief
    img = torch.as_tensor(frames[0]["gray"], device=dev).float() / 255.0
    uv, _, ok = klt.detect_grid_plain(klt.shi_tomasi_plain(img),
                                      torch.zeros((1, 2), device=dev), 20, 150,
                                      torch.zeros(1, device=dev))
    other = brief.brief_describe_plain(img, uv + 0.5, ok)[0]
    r = checks.check_brief(dev, img.cpu().numpy(), uv.cpu().numpy(),
                           ok.cpu().numpy(), other.cpu().numpy().view("uint32"))
    assert all(v["ok"] for v in r.values()), r


def test_loop_geom_kernel_matches_plain(dev):
    import numpy as np
    from ground_fusion2_tpu_torch.core.prng import gumbel_noise
    rng = np.random.default_rng(0)
    F, M = 150, 90
    ang = rng.normal(scale=0.2, size=3)
    from ground_fusion2_tpu_torch.core import lie
    R = lie.so3_exp(torch.as_tensor(ang, dtype=torch.float32)).double().numpy()
    t = rng.normal(scale=0.3, size=3)
    pj = np.c_[rng.uniform(-2, 2, (M, 2)), rng.uniform(2, 6, M)]
    pi = pj @ R.T + t
    ni = pi[:, :2] / pi[:, 2:] + rng.normal(scale=0.002, size=(M, 2))
    ni[:15] += rng.normal(scale=0.3, size=(15, 2))
    pad = lambda a, w: np.r_[a, np.zeros((F - M, w))].astype(np.float32)
    x = [torch.as_tensor(a, device=dev) for a in (
        pad(pj, 3), pad(ni, 2), pad(pi, 3),
        np.r_[np.ones(M), np.zeros(F - M)].astype(np.float32),
        np.r_[rng.uniform(size=M) > 0.2, np.zeros(F - M)].astype(np.float32))]
    r = checks.check_loop_geom(dev, x, 0.08, gumbel_noise(5, 128, F, dev))
    assert r["ok"] and r["n_inliers"] >= 60, r


@pytest.mark.parametrize("six", [False, True], ids=["4dof", "6dof"])
@pytest.mark.parametrize("n,cap", [(60, 64), (500, 512)])
def test_pg_normal_kernel_matches_plain(dev, six, n, cap):
    r = checks.check_pg_normal(dev, checks.ring_graph_args(n, cap, dev, six))
    assert r["ok"] and r["repeat_equal"], r


def _lm_deltas(dev, x0, meas, layout, vcfg):
    """delta = 0, the damped LM step from there and its reverse."""
    step = checks.lm_trial(x0, meas, layout, vcfg)
    return dict(zero=torch.zeros(layout.dim, device=dev), accepted=step,
                rejected=-step)


@pytest.mark.parametrize("rows", ["camera", "gnss"])
def test_window_cost_kernel_matches_plain(dev, window, rows):
    """Kernel S at delta = 0, an accepted and a rejected LM step: within
    max(3× the plain route's error, 1e-6) of float64, the same bits twice,
    the same accept/reject as the plain route."""
    from ground_fusion2_tpu_torch.config import VioConfig
    x0, feats, layout, _, meas, vcfg = window
    if rows == "gnss":
        x0, meas = checks.example_gnss(x0, meas, layout, dev)
        vcfg = VioConfig(num_feats=150, use_gnss=True)
    r = checks.check_window_cost(dev, x0, meas, layout, vcfg,
                                 _lm_deltas(dev, x0, meas, layout, vcfg),
                                 timed=False)
    assert r["ok"] and r["repeat_equal"] and r["decisions_equal"], r
    assert r["decisions"]["accepted"]["kernel"], r
    assert not r["decisions"]["rejected"]["kernel"], r


def test_window_cost_kernel_on_a_fused_window(dev, camera):
    cfg, fv, _, _ = camera
    meas = checks.carry_measurements(fv)
    vcfg = cfg.estimator.vio
    r = checks.check_window_cost(dev, fv.carry.state, meas, fv.layout, vcfg,
                                 _lm_deltas(dev, fv.carry.state, meas,
                                            fv.layout, vcfg), timed=False)
    assert r["ok"] and r["decisions_equal"], r


def test_window_cost_kernel_with_the_prior_invalid(dev, window):
    """Kernel S with the marginalization prior switched off (its rows
    weighted 0) at zero, an accepted and a rejected step."""
    x0, _, layout, _, meas, vcfg = window
    m = meas._replace(prior=meas.prior._replace(
        valid=torch.zeros_like(meas.prior.valid)))
    r = checks.check_window_cost(dev, x0, m, layout, vcfg,
                                 _lm_deltas(dev, x0, m, layout, vcfg),
                                 timed=False)
    assert r["ok"] and r["repeat_equal"] and r["decisions_equal"], r


def test_window_cost_kernel_repeats_after_another_window(dev, window):
    """The same bits from one closure before and after a call on another
    window (the GNSS one): each launch leaves its ticket at 0."""
    from ground_fusion2_tpu_torch.config import VioConfig
    from ground_fusion2_tpu_torch.factors import vio_factors as fac
    x0, _, layout, delta, meas, vcfg = window
    xg, mg = checks.example_gnss(x0, meas, layout, dev)
    cam = fac.window_cost_fn(x0, meas, layout, vcfg)
    gnss = fac.window_cost_fn(xg, mg, layout, VioConfig(num_feats=150,
                                                        use_gnss=True))
    a = cam(delta)
    b = gnss(delta)
    c = cam(delta)
    assert torch.equal(a, c) and torch.equal(b, gnss(delta)), (a, b, c)
    assert torch.equal(cam(torch.zeros_like(delta)),
                       cam(torch.zeros_like(delta)))


def test_window_cost_kernel_refuses_another_stream(dev, window):
    """A closure's scratch (partials, ticket) belongs to the stream it was
    made on: a call on another stream raises."""
    from ground_fusion2_tpu_torch.factors import vio_factors as fac
    x0, _, layout, delta, meas, vcfg = window
    cam = fac.window_cost_fn(x0, meas, layout, vcfg)
    with torch.cuda.stream(torch.cuda.Stream(dev)):
        with pytest.raises(RuntimeError, match="another stream"):
            cam(delta)


@pytest.mark.parametrize("rows", ["camera", "gnss"])
def test_window_cost_kernel_launches_once_a_call(dev, window, rows):
    from ground_fusion2_tpu_torch.config import VioConfig
    from ground_fusion2_tpu_torch.factors import vio_factors as fac
    x0, _, layout, delta, meas, vcfg = window
    if rows == "gnss":
        x0, meas = checks.example_gnss(x0, meas, layout, dev)
        vcfg = VioConfig(num_feats=150, use_gnss=True)
    fn = fac.window_cost_fn(x0, meas, layout, vcfg)
    d = delta.to(torch.float32).contiguous()
    _kernels.launches.clear()
    dt = checks.device_ms(lambda: fn(d))
    assert dt.launches == 1, dt
    assert _kernels.launches["window_cost"] == dt.calls, (
        dict(_kernels.launches), dt)


@pytest.mark.parametrize("six", [False, True], ids=["4dof", "6dof"])
@pytest.mark.parametrize("n,cap", [(60, 64), (500, 512)])
def test_pg_cost_kernel_matches_plain(dev, six, n, cap):
    r = checks.check_pg_cost(dev, checks.ring_graph_args(n, cap, dev, six))
    assert r["ok"] and r["repeat_equal"], r


def test_global_cost_kernel_matches_plain(dev):
    r = checks.check_global_cost(dev, _global_graph(dev).graph.to(dev))
    assert r["ok"] and r["repeat_equal"], r


@pytest.mark.parametrize("tracks", ["live", "two_observations"])
def test_triangulate_kernel_matches_plain(dev, camera, tracks):
    """Kernel T on every live track of a fused window (the depth fix
    cleared), and with every third track cut to 2 observations."""
    _, fv, _, _ = camera
    fw, st, _, _ = checks.window_stage_inputs(fv)
    fw = fw._replace(depth_fixed=torch.zeros_like(fw.depth_fixed))
    if tracks == "two_observations":
        ov = fw.obs_valid.clone()
        W = ov.shape[1]
        ov[::3] = 0.0
        ov[::3, W - 2:] = 1.0
        fw = fw._replace(obs_valid=ov,
                         anchor=torch.where(torch.arange(ov.shape[0],
                                                         device=dev) % 3 == 0,
                                            W - 2, fw.anchor))
    r = checks.check_triangulate(dev, fw, st, st.rho, torch.ones_like(st.rho))
    assert r["ok"] and r["done"] > 0, r


@pytest.mark.parametrize("outlier_px", [None, 0.5])
def test_window_tests_kernel_matches_plain(dev, camera, outlier_px):
    """Kernel U's two modes on a fused window, at the tick's outlier gate
    and at a 0.5 px gate that drops tracks."""
    _, fv, _, _ = camera
    fw, st, _, interval = checks.window_stage_inputs(fv)
    s = fv.statics if outlier_px is None else fv.statics._replace(
        outlier_px=outlier_px)
    W = fw.obs_valid.shape[1]
    r = checks.check_window_tests(dev, fw, st, s, torch.zeros(
        (), dtype=torch.bool, device=dev), interval, W - 2)
    assert r["ok"], r
    if outlier_px is not None:
        assert r["dropped"] > 0, r


def test_window_update_kernel_matches_plain(dev, camera):
    _, fv, _, _ = camera
    fw, st, obs, _ = checks.window_stage_inputs(fv)
    W = fw.obs_valid.shape[1]
    r = checks.check_window_update(dev, fw, st, st.rho, obs, W - 1)
    assert r["ok"], r
    assert r["modes"]["slide_oldest"]["rho_moved"] >= 0


@pytest.mark.parametrize("shape", checks.EDGE_SHAPES,
                         ids=lambda s: f"F{s[0]}-W{s[1]}")
def test_feature_window_kernels_on_edge_windows(dev, shape):
    """Kernels V (every mode) and T on ``checks.edge_window``'s windows: one
    track and 37, 3 and 16 frames, tracks at their edges (no later
    observation, re-anchored behind the new frame, 0, 1 and 2
    observations, coinciding rays, a point beyond the |h3| guard)."""
    e = checks.edge_inputs(checks.edge_window(0, *shape), dev)
    r = checks.check_window_update(dev, e["fw"], e["x"], e["rho"], e["obs"],
                                   e["col"])
    assert r["ok"], r
    t = checks.check_triangulate(dev, e["fw"], e["x"], e["rho"], e["uninit"])
    assert t["ok"], t


def test_window_update_refuses_aliasing(dev):
    """Kernel V's entry point refuses an output that overlaps an input or
    another output (its loads are all issued before any store), and takes
    the same call on separate arrays."""
    import ctypes
    e = checks.edge_inputs(checks.edge_window(0, 37, 16), dev)
    fw, x, rho = e["fw"], e["x"], e["rho"]
    ins = [fw.ray, fw.vel, fw.depth, fw.obs_valid, fw.anchor, fw.track_valid,
           fw.depth_fixed, rho]
    P = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    F, W = fw.obs_valid.shape

    def call(outs):
        return _kernels.library().gf2_window_update(
            1, *map(P, ins), F, W, *[P(None)] * 5, 0, ctypes.c_float(0.1),
            ctypes.c_float(7.0), P(x.p), P(x.q), P(x.tic), P(x.qic),
            *map(P, outs), P(None), stream)

    fresh = lambda: [torch.empty_like(t) for t in ins]
    assert call(fresh()) == 0
    outs = fresh()
    outs[7] = rho                               # rho out onto rho in
    assert call(outs) != 0
    outs = fresh()
    outs[1] = outs[0][1:]                       # vel out inside ray out
    assert call(outs) != 0
    outs = fresh()
    outs[3] = x.p                               # obs_valid out over the pose
    assert call(outs) != 0
    torch.cuda.synchronize()


def test_camera_tick_launches_s_to_v(dev, camera):
    """One more fused tick launches S once a trial cost (1 + 8, the 8 with
    AN's step in their last CTA), T, U twice (before and after the solve)
    and V (add_frame, and a slide when the window is full), and no plain
    cost and no standalone step."""
    cfg, fv, fs, _ = camera
    f = fs[-1]
    _kernels.launches.clear()
    fv.process_image(f["t"] + 0.05, f["gray"], f["depth"], f["imu"],
                     wheel_vel=f["wheel"])
    n = dict(_kernels.launches)
    assert n["window_cost"] == 1 + cfg.estimator.vio.max_iters, n
    # each trial cost's S runs AN's step in its last CTA
    assert n["window_cost_step"] == cfg.estimator.vio.max_iters, n
    assert n.get("lm_step", 0) == 0, n
    assert n["triangulate"] == 1 and n["window_tests"] == 2, n
    assert n["window_update"] in (1, 2), n


def test_kernels_count_their_launches(dev, frames, lio):
    _kernels.launches.clear()
    checks.check_proj(dev, timed=False)
    assert _kernels.launches["proj_normal"] == 2     # the call and its repeat
    assert _kernels.launches["clahe"] == 0
    lo, s, _ = lio
    _kernels.launches.clear()
    lo.process_scan(s["t"], s["pts"], s["alpha"], s["valid"], s["imu"])
    n = dict(_kernels.launches)
    it = lo.cfg.icp_cfg.outer_iters
    assert n["eskf_predict"] == 1
    assert n["lio_assoc"] == it + 1          # every GN iteration + degeneracy
    assert n["ct_icp_normal"] == it
    assert n["ct_icp_solve"] == it           # each E solves in its last CTA
    assert n.get("icp_solve", 0) == 0
    assert n["ct_glue"] == 1                 # AK transforms the scan alone
    assert n["radix_sort"] >= 2 + 4          # keypoints + insert
    assert n.get("proj_normal", 0) == 0
    assert n.get("preint", 0) == 0


def test_camera_tick_launches_h_to_k(dev, camera):
    """One fused camera tick: kernel H once (its blocks running Y's
    square-root informations; Y's standalone entry never), I four times
    (three levels and the response), J and K once."""
    cfg, fv, fs, _ = camera
    f = fs[-1]
    _kernels.launches.clear()
    fv.process_image(f["t"] + 0.1, f["gray"], f["depth"], f["imu"],
                     wheel_vel=f["wheel"])
    n = dict(_kernels.launches)
    assert (n["preint"], n["pyramid"], n["shi_tomasi"], n["detect_grid"],
            n["ransac_f"]) == (1, 3, 1, 1, 1), n
    assert n["preint_sqrt_info"] == 1 and n.get("sqrt_info", 0) == 0, n
    # kernel L beside kernel C at every linearization of the window
    assert n["small_normal"] == n["proj_normal"] >= 9, n


@pytest.mark.parametrize("n,cap,six", [(396, None, False), (60, 64, False),
                                       (500, 512, False), (250, 256, True)],
                         ids=["window396", "pg256", "pg2048", "global1536"])
def test_chol_solve_kernel_matches_plain(dev, window, n, cap, six):
    """Kernel W at the main path's sizes: the window's D = 396 (one CTA),
    the pose graph's 4·64 and 4·512 and a 6·256 graph (the global graph's
    1536, cooperative)."""
    free = None
    if cap is None:
        x0, _, layout, delta, meas, vcfg = window
        from ground_fusion2_tpu_torch.vio.problem import window_normal_equations
        H, g, _ = window_normal_equations(x0, meas, layout, vcfg, delta)
    else:
        from ground_fusion2_tpu_torch.posegraph import pose_graph as pgm
        args = checks.ring_graph_args(n, cap, dev, six)
        d = 6 if six else 4
        H, g, _ = pgm.pg_normal_equations(*args, torch.zeros(cap * d,
                                                             device=dev))
        free = checks.pg_free_mask(n, cap, d, dev)
    r = checks.check_chol_solve(dev, H, g, free, timed=False)
    assert r["ok"] and r["repeat_equal"] and r["nan_on_non_pd"], r


def test_sym_eig_kernel_matches_plain(dev, window):
    """Kernel X through ``marginalize`` on the example window's MARGIN_OLD
    (drop 170 / keep 226) and MARGIN_SECOND_NEW (drop 20 of the 246-dim
    prior / keep 226)."""
    x0, _, layout, _, meas, vcfg = window
    r = checks.check_sym_eig(dev, checks.marg_systems(x0, meas, layout, vcfg),
                             timed=False)
    assert r["ok"], r
    dims = {k: v["dims"] for k, v in r["systems"].items()}
    assert dims == {"margin_old": (226, 170),
                    "margin_second_new": (226, 20)}, dims


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_sym_eig_kernel_nan_when_unconverged(dev, dtype, tol):
    """Kernel X on matrices it cannot finish: a seeded symmetric 40×40 with
    no secular step allowed, and the same matrix holding a NaN pair (a
    non-finite input). Every w and every entry of V is NaN, where the plain
    eigh raises. With its 30 steps the finite matrix is solved: eigenvalues
    within ``tol`` of ``eigh``'s, relative to the largest."""
    import numpy as np
    from ground_fusion2_tpu_torch.solver.marginalize import (_sym_eig_cuda,
                                                             sym_eig)
    a = np.random.default_rng(7).standard_normal((40, 40))
    A = torch.as_tensor(a + a.T, dtype=dtype, device=dev)
    w, V = _sym_eig_cuda(A, max_iters=0)
    assert bool(torch.isnan(w).all()) and bool(torch.isnan(V).all())
    bad = A.clone()
    bad[5, 3] = bad[3, 5] = float("nan")
    w, V = sym_eig(bad)
    assert bool(torch.isnan(w).all()) and bool(torch.isnan(V).all())
    w, V = sym_eig(A)
    ref = torch.linalg.eigvalsh(A.double())
    err = float((w.double() - ref).abs().max() / ref.abs().max())
    assert bool(torch.isfinite(V).all()) and err <= tol, err


# kernel X on checks.eig_case's hard inputs: eigenvalues against LAPACK's
# eigh on the host and the residual max|AV − VΛ| (relative to max|A|), and
# max|VᵀV − I|, each within EIG_CASE_NEPS·n·eps (float64); the numpy model of
# the same algorithm stays below 2.1·n·eps on them
# (tests/test_torch_sym_eig_model.py). The card's eigvalsh is no reference
# here: on tiny_entries it is 7e-5 off while X's residual is 0.3·n·eps.
EIG_CASE_NEPS = 4.0


@pytest.mark.parametrize("n", [1, 2, 20, 32, 33, 170, 226, 246, 768])
@pytest.mark.parametrize("kind", checks.EIG_CASES)
def test_sym_eig_kernel_on_hard_inputs(dev, kind, n):
    """X on a diagonal matrix, I + uuᵀ, exact zero rows, a graded spectrum
    and Wilkinson's close pairs, from 1 to its largest size: within the
    tolerances above, and the same bits twice."""
    from ground_fusion2_tpu_torch.solver.marginalize import sym_eig
    A = torch.as_tensor(checks.eig_case(kind, n), device=dev)
    w, V = sym_eig(A)
    w2, V2 = sym_eig(A)
    assert torch.equal(w, w2) and torch.equal(V, V2)
    eps = 2.0 ** -53
    scale = float(A.abs().max().clamp(min=1e-300)) * n * eps
    errs = (float((w.cpu() - torch.linalg.eigvalsh(A.cpu())).abs().max()) / scale,
            float((A @ V - V * w[None, :]).abs().max()) / scale,
            float((V.T @ V - torch.eye(n, dtype=A.dtype, device=dev)).abs().max())
            / (n * eps))
    assert bool(torch.isfinite(V).all()) and max(errs) <= EIG_CASE_NEPS, errs
    assert bool((w[1:] >= w[:-1]).all())


def test_small_linalg_kernels_match_plain(dev, camera, lio):
    """Kernel Y: the camera window's square-root informations, the ESKF's
    innovation inverse, CT-ICP's damped solve and degeneracy test."""
    from ground_fusion2_tpu_torch.lio import ct_icp as ci
    _, fv, _, _ = camera
    lo, _, x = lio
    icp = lo.cfg.icp_cfg
    H, g, _ = ci.normal_equations(x["pose"], x["pose"], x["kp"], x["ka"],
                                  x["centroid"], x["normal"], x["w"], icp)
    r = checks.check_small_linalg(
        dev, checks.sqrt_info_inputs(fv), checks.eskf_innovation(lo), H, g,
        icp.damping, x["normal"], x["w"], icp, timed=False)
    assert all(v["ok"] for v in r.values()), r
    assert r["degeneracy"]["n_sel"] > icp.min_normals, r


def test_occupancy_kernel_matches_plain(dev):
    """Kernel Z on a lifted room sweep seen from 0.3 m off the origin: the
    cell of every sample equal, the log-odds within their rounding bound,
    from an empty grid and from one that already holds a scan."""
    from ground_fusion2_tpu_torch.mapping.occupancy import GridConfig
    s = checks.lidar_drive(2, z=1.0)[1]
    pts = torch.as_tensor(s["pts"], device=dev)
    valid = torch.as_tensor(s["valid"] > 0.5, device=dev)
    origin = torch.tensor([0.3, -0.2], device=dev)
    r = checks.check_occupancy(dev, GridConfig(), origin, pts, valid,
                               timed=False)
    assert r["ok"] and r["increments"] > 10_000, r
    grid = torch.zeros((400, 400), device=dev)
    from ground_fusion2_tpu_torch.mapping.occupancy import scatter_scan_plain
    scatter_scan_plain(grid, origin, pts, valid, GridConfig())
    r = checks.check_occupancy(dev, GridConfig(), origin, pts, valid, grid,
                               timed=False)
    assert r["ok"], r


@pytest.fixture(scope="module")
def mesh_case(dev):
    """A store at the JAX package's MeshConfig() defaults filled on the card
    from 8 chunks of a synthetic room cloud, the next chunk, a 480×640
    texture seen from 4 m above the floor with the M3DGR intrinsics, and 32
    live voxels to retriangulate."""
    import numpy as np
    from ground_fusion2_tpu_torch.mesh import incremental as mi
    cfg = mi.MeshConfig()
    cloud = torch.as_tensor(checks.mesh_room_cloud(9 * cfg.insert_chunk),
                            device=dev)
    mesh = mi.MeshMap.empty(cfg, device=dev)
    ones = torch.ones(cfg.insert_chunk, device=dev)
    for k in range(8):
        mesh, _ = mi.insert(mesh, cloud[k * cfg.insert_chunk:
                                        (k + 1) * cfg.insert_chunk], ones, cfg)
    v, u = np.mgrid[0:480, 0:640].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(u / 37 + c) * np.cos(v / 23)
                    for c in range(3)], -1).astype(np.float32)
    view = (checks.M3DGR_INTRINSICS,
            np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32),
            np.array([0.3, -0.2, 4.0], np.float32))
    live = torch.unique(mesh.code[mesh.code != mi.INVALID])
    codes = live[torch.randperm(live.numel(), generator=torch.Generator()
                                .manual_seed(0))[:cfg.dirty_batch].to(dev)]
    return (cfg, mesh, cloud[8 * cfg.insert_chunk:], ones,
            torch.as_tensor(img, device=dev), view, codes.to(torch.int32))


def test_mesh_insert_kernel_matches_plain(dev, mesh_case):
    """Kernel AA on the next chunk: codes and pw equal, the means bit for
    bit against the CPU's pass and within rounding of the card's, the same
    bits twice, the whole insert equal to insert_plain; and an insert that
    overflows a small store, with its evicted codes equal."""
    from ground_fusion2_tpu_torch.mesh import incremental as mi
    cfg, mesh, chunk, ones = mesh_case[:4]
    r = checks.check_mesh_insert(dev, mesh, chunk, ones, cfg, timed=False)
    assert r["ok"] and r["kept"] > 5000, r
    small = cfg._replace(capacity=1024)
    store = mi.MeshMap.empty(small, device=dev)
    r = checks.check_mesh_insert(dev, store, chunk, ones, small, timed=False)
    assert r["ok"], r
    _, ev = mi.insert(store, chunk, ones, small)
    assert int((ev != mi.INVALID).sum()) > 100


def test_mesh_rgb_kernel_matches_plain(dev, mesh_case):
    cfg, mesh, img, view = mesh_case[0], mesh_case[1], mesh_case[4], mesh_case[5]
    r = checks.check_mesh_rgb(dev, mesh, img, *view, cfg, timed=False)
    assert r["ok"] and r["visible"] > 300, r


@pytest.mark.parametrize("B", [1, 32, 33, 4544, 10000])
def test_mesh_delaunay_one_launch_any_batch(dev, mesh_case, B):
    """Kernel AC over B voxels in one launch, as a drain launches it (the
    store's dirty set, its live voxels and their face neighbours in a
    seeded order, cycled to B): against retriangulate_plain by the band rule, bit-equal to launches
    of 32 voxels on the same codes and to itself, the packed form at
    disjoint offsets; one launch a call."""
    from ground_fusion2_tpu_torch.mesh import incremental as mi
    cfg, mesh = mesh_case[0], mesh_case[1]
    live = torch.unique(mesh.code[mesh.code != mi.INVALID])
    nb = mi._pack(mi._unpack(live)[:, None, :]
                  + torch.as_tensor(mi.FACE_NBR, device=dev))
    dirty = torch.unique(nb.reshape(-1)).to(torch.int32)
    dirty = dirty[torch.randperm(dirty.numel(), generator=torch.Generator()
                                 .manual_seed(0)).to(dev)]
    codes = dirty.repeat(-(-B // dirty.numel()))[:B]
    _kernels.launches.clear()
    mi.retriangulate_packed(mesh, codes, cfg)
    assert _kernels.launches["mesh_delaunay"] == 1
    r = checks.check_mesh_delaunay(dev, mesh, codes, cfg, timed=False)
    flags = {k: r[k] for k in ("ok", "batch_equal", "packed_equal",
                               "repeat_equal", "outputs_equal",
                               "differing_triples", "differing_off_band",
                               "named", "triangles")}
    assert r["ok"] and r["batch_equal"] and r["packed_equal"], flags
    assert B == 1 or r["triangles"] > 10, flags


def test_mesh_delaunay_kernel_matches_plain(dev, mesh_case):
    cfg, mesh, codes = mesh_case[0], mesh_case[1], mesh_case[6]
    r = checks.check_mesh_delaunay(dev, mesh, codes, cfg, timed=False)
    assert r["ok"] and r["triangles"] > 200, r


@pytest.fixture(scope="module")
def line_pair(dev, frames):
    """Frames 0 and 1 of the room drive (÷ 255) on the card, their 3-level
    pyramids and frame 0's segments, as the line path takes them."""
    from ground_fusion2_tpu_torch.frontend import klt, lines
    g = [torch.as_tensor(f["gray"], device=dev).float() / 255.0
         for f in frames]
    segs, valid = lines.detect_lines(g[0])
    return g, klt.build_pyramid(g[0], 3), klt.build_pyramid(g[1], 3), segs, \
        valid


def test_line_detect_kernel_matches_plain(dev, line_pair):
    """Kernel AD on a 640×480 frame: thresholds bit for bit, flags equal
    (or named within the band), endpoints within tolerance, twice the same
    bits."""
    r = checks.check_line_detect(dev, line_pair[0][0], timed=False)
    assert r["ok"] and r["valid"] > 20, r


def test_line_refit_kernel_matches_plain(dev, line_pair):
    """Kernel AE's sample mode bit for bit, B at the line path's arguments,
    the refit's flags and segments; twice the same bits."""
    _, p0, p1, segs, valid = line_pair
    r = checks.check_line_refit(dev, p0, p1, segs, valid, timed=False)
    assert r["ok"] and r["valid"] > 20 and r["klt"]["tracked"] > 100, r


def test_track_lines_launches_ae_and_b(dev, line_pair):
    from ground_fusion2_tpu_torch.frontend import lines
    _, p0, p1, segs, valid = line_pair
    _kernels.launches.clear()
    s1, v1 = lines.track_lines(p0, p1, segs, valid)
    assert _kernels.launches["line_refit"] == 2
    assert _kernels.launches["klt"] == 1
    assert s1.is_cuda and int(v1.sum()) > 20


@pytest.mark.parametrize("world", [1, 2])
def test_dist_schur_kernel_matches_plain(dev, world):
    """Kernel AF on rank 0's shard of the F = 150 example window (the whole
    window at world 1, half of it at 2), λ = 1e-3."""
    from ground_fusion2_tpu_torch.config import VioConfig
    from ground_fusion2_tpu_torch.parallel import dist_ba
    from ground_fusion2_tpu_torch.vio.state import WindowLayout
    x0, feats, layout, _ = checks.example_window(150, dev)
    meas = checks.example_measurements(x0, feats, layout, dev)
    xs, ms = dist_ba.shard_window(x0, meas, 0, world)
    r = checks.check_dist_schur(dev, xs, ms.feats, WindowLayout(150 // world),
                                VioConfig(num_feats=150), lam=1e-3,
                                timed=False)
    assert r["ok"] and r["rows"] > 500 // world, r


@pytest.mark.parametrize("shard", [0, 1])
def test_map_schur_kernel_matches_plain(dev, shard):
    """Kernel AG at tools/bench_weak_scaling.py's widths (K = 64, 128
    landmarks a keyframe, halo 3) on shard 0 of 1 and on the last of two
    (its halo wraps past K·6 and is masked)."""
    from ground_fusion2_tpu_torch.parallel import dist_mapping as dm
    world = 1 + shard
    prob, _ = dm.make_mapping_problem(64, 128, 3, seed=1, perturb=0.05)
    prob = dm.MappingProblem(*(t.to(dev) for t in prob))
    sh = dm.shard_problem(prob, shard, world)
    pe, qe = dm.halo_exchange(sh.kf_p, sh.kf_q, 3, None)
    r = checks.check_map_schur(dev, pe, qe, sh, 3, 64, shard * 64 // world,
                               lam=2e-3, timed=False)
    assert r["ok"] and r["landmarks"] == 8192 // world, r


def test_chol_solve_explicit_diagonal(dev):
    """W's explicit-diagonal mode against its twin on the mapping system
    (K = 64: 384 dims), and diag(Hm) handed explicitly gives the default
    mode's bits."""
    from ground_fusion2_tpu_torch.parallel import dist_mapping as dm
    from ground_fusion2_tpu_torch.solver.gauss_newton import _solve_damped
    prob, _ = dm.make_mapping_problem(64, 128, 3, seed=1, perturb=0.05)
    prob = dm.MappingProblem(*(t.to(dev) for t in prob))
    pe, qe = dm.halo_exchange(prob.kf_p, prob.kf_q, 3, None)
    b = dm.map_build(pe, qe, prob, 3, 64, 0, torch.full((), 1e-4, device=dev))
    K6 = 64 * 6
    H, g, diag = b.pay[:, :K6], b.pay[:, K6], b.pay[:, K6 + 1]
    free = torch.ones(K6, device=dev)
    free[:6] = 0.0
    r = checks.check_chol_solve(dev, H, g, free, damp_diag=diag * free,
                                timed=False)
    assert r["ok"] and r["explicit_diagonal"], r
    lam = torch.full((), 1e-4, device=dev)
    hm = torch.diagonal(H) * free * free
    assert torch.equal(_solve_damped(H, g, lam, free),
                       _solve_damped(H, g, lam, free, damp_diag=hm))


def _spd_system(n, dev, seed=0):
    """A seeded SPD system of size n (condition ~1e3 once equilibrated) and
    its right-hand side."""
    import numpy as np
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, n)) / np.sqrt(n)
    H = B @ B.T + np.diag(rng.uniform(1e-3, 10.0, n))
    g = rng.standard_normal(n)
    return (torch.as_tensor(H, dtype=torch.float32, device=dev),
            torch.as_tensor(g, dtype=torch.float32, device=dev))


@pytest.mark.parametrize("n", [1, 31, 32, 33, 511, 512, 513, 4096])
def test_chol_solve_kernel_at_mode_boundaries(dev, n):
    """W on both sides of its cluster / cooperative boundary (512) and of
    a tile (32), at 1 and at its largest size: within the gate against
    float64, NaN on a non-PD input, the same bits twice; with every seventh
    dim pinned the pinned dims of dx are 0."""
    H, g = _spd_system(n, dev, seed=n)
    r = checks.check_chol_solve(dev, H, g, timed=False)
    assert r["ok"] and r["repeat_equal"] and r["nan_on_non_pd"], r
    if n < 8:
        return
    free = torch.ones(n, device=dev)
    free[::7] = 0.0
    r = checks.check_chol_solve(dev, H, g, free, timed=False)
    assert r["ok"] and r["repeat_equal"] and r["nan_on_non_pd"], r
    from ground_fusion2_tpu_torch.solver.gauss_newton import _solve_damped
    dx = _solve_damped(H, g, torch.full((), 1e-4, device=dev), free)
    assert bool((dx[::7] == 0).all()) and bool(torch.isfinite(dx).all())


@pytest.mark.parametrize("n", [384, 1536])
def test_chol_solve_explicit_diagonal_at_both_modes(dev, n):
    """W's explicit-diagonal mode in the cluster (384) and the cooperative
    (1536) mode: against its twin, and diag(Hm) handed explicitly gives the
    default mode's bits."""
    from ground_fusion2_tpu_torch.solver.gauss_newton import _solve_damped
    H, g = _spd_system(n, dev, seed=n + 1)
    free = torch.ones(n, device=dev)
    free[:6] = 0.0
    diag = torch.diagonal(H) * 1.5
    r = checks.check_chol_solve(dev, H, g, free, damp_diag=diag * free,
                                timed=False)
    assert r["ok"] and r["explicit_diagonal"] and r["repeat_equal"], r
    lam = torch.full((), 1e-4, device=dev)
    hm = torch.diagonal(H) * free * free
    assert torch.equal(_solve_damped(H, g, lam, free),
                       _solve_damped(H, g, lam, free, damp_diag=hm))


def _launch(name, dev):
    from ground_fusion2_tpu_torch.config import EskfOptions, VoxelMapConfig
    if name == "ct_glue":
        from ground_fusion2_tpu_torch.lio import ct_icp
        q = torch.tensor([1.0, 0, 0, 0], device=dev)
        z3 = torch.zeros(3, device=dev)
        return ct_icp.transform_points(ct_icp.CtPose(q, z3, q, z3),
                                       torch.ones((8, 3), device=dev),
                                       torch.zeros(8, device=dev))
    if name == "voxel_glue":
        from ground_fusion2_tpu_torch.lio import voxel_map as vm
        cfg = VoxelMapConfig(capacity=64)
        return vm.insert_keys(vm.VoxelMap.empty(cfg, dev),
                              torch.ones((8, 3), device=dev),
                              torch.ones(8, device=dev), cfg)
    if name == "lio_update":
        from ground_fusion2_tpu_torch.lio import eskf, fused
        s = eskf.EskfState.initial(device=dev)
        sw = fused.SwitchCarry.initial([1.0, 0, 0, 0], [0.0] * 3,
                                       [1.0, 0, 0, 0], [0.0] * 3, dev)
        z = torch.zeros((), device=dev)
        return fused.lio_update(s, s.p, s.q, s.p, s.q, z,
                                torch.zeros((), dtype=torch.bool, device=dev),
                                z, s.p, sw, s.p, 50.0)
    if name == "track_tail":
        from ground_fusion2_tpu_torch.core.cameras import Pinhole
        from ground_fusion2_tpu_torch.frontend import track_tail
        return track_tail.lift_norm(Pinhole.create(80.0, 80.0, 64.0, 48.0),
                                    torch.ones((8, 2), device=dev))
    if name == "threefry":
        from ground_fusion2_tpu_torch.core import prng
        return prng.gumbel_noise(1, 4, 8, dev)
    if name == "calib_normal":
        from ground_fusion2_tpu_torch.calib import intrinsics as ci
        obj, uv = checks.calib_views(False, n_views=3, nx=4, ny=3)
        prob = ci.calib_problem(obj, uv, 8, dev)
        return ci.normal_equations(prob, torch.zeros(prob.dim, device=dev))
    if name == "window_carry":
        from ground_fusion2_tpu_torch.vio import window_carry
        c = checks.carry_from_arrays(*checks.carry_arrays(0, 30, 40), dev)
        f = dict(t=1.0, imu=(torch.zeros(3, 3).numpy(),
                             torch.zeros(3, 3).numpy(),
                             torch.full((2,), 0.005).numpy()))
        return window_carry.write(c, checks.carry_frame_inputs(dev, f, 5,
                                                               False), True)
    if name == "marg_schur":
        from ground_fusion2_tpu_torch.solver.marginalize import marginalize
        import numpy as np
        return marginalize(torch.eye(8, device=dev), torch.ones(8, device=dev),
                           np.arange(5), np.arange(5, 8))
    if name == "chol_solve":
        from ground_fusion2_tpu_torch.solver.gauss_newton import _solve_damped
        one = torch.ones(8, device=dev)
        return _solve_damped(torch.eye(8, device=dev), one,
                             torch.full((), 1e-4, device=dev), one)
    if name == "sym_eig":
        from ground_fusion2_tpu_torch.solver.marginalize import sym_eig
        return sym_eig(torch.eye(8, dtype=torch.float64, device=dev))
    if name in ("sqrt_info", "spd_inverse"):
        from ground_fusion2_tpu_torch.factors.vio_factors import imu_sqrt_info
        from ground_fusion2_tpu_torch.lio.eskf import spd_inverse
        eye = torch.eye(6, device=dev)
        return (imu_sqrt_info(eye[None]) if name == "sqrt_info"
                else spd_inverse(eye))
    if name in ("icp_solve", "degeneracy"):
        from ground_fusion2_tpu_torch.lio import ct_icp
        if name == "icp_solve":
            return ct_icp.damped_solve(torch.eye(12, device=dev),
                                       torch.ones(12, device=dev), 1e-3)
        return ct_icp.degeneracy(torch.ones((8, 3), device=dev),
                                 torch.ones(8, device=dev), m3dgr_lio().icp_cfg)
    if name in ("mesh_insert", "mesh_rgb", "mesh_delaunay"):
        from ground_fusion2_tpu_torch.mesh import incremental as mi
        cfg = mi.MeshConfig(capacity=64, insert_chunk=16)
        mesh = mi.MeshMap.empty(cfg, device=dev)
        if name == "mesh_insert":
            z = torch.zeros(16, dtype=torch.int32, device=dev)
            return mi.insert_pass(z, z, torch.zeros((16, 3), device=dev),
                                  torch.ones(16, device=dev), 12)
        if name == "mesh_rgb":
            return mi.update_rgb(mesh, torch.zeros((8, 8, 3), device=dev),
                                 (4.0, 4.0, 4.0, 4.0), torch.eye(3).numpy(),
                                 (0.0, 0.0, -1.0), cfg)
        return mi.retriangulate(mesh, torch.zeros(4, dtype=torch.int32,
                                                  device=dev), cfg)
    if name in ("line_detect", "line_refit"):
        from ground_fusion2_tpu_torch.frontend import lines
        if name == "line_detect":
            return lines.detect_lines(torch.zeros((48, 64), device=dev))
        return lines.line_samples(torch.zeros((4, 4), device=dev),
                                  torch.ones(4, device=dev), 8)
    if name == "dist_schur":
        from ground_fusion2_tpu_torch.config import VioConfig
        from ground_fusion2_tpu_torch.parallel import dist_ba
        x0, feats, layout, _ = checks.example_window(8, dev)
        return dist_ba.shard_reduce(x0, feats, layout, VioConfig(num_feats=8),
                                    torch.full((), 1e-4, device=dev))
    if name == "map_schur":
        from ground_fusion2_tpu_torch.parallel import dist_mapping as dm
        prob, _ = dm.make_mapping_problem(4, 4, 2)
        prob = dm.MappingProblem(*(t.to(dev) for t in prob))
        pe, qe = dm.halo_exchange(prob.kf_p, prob.kf_q, 2, None)
        return dm.map_build(pe, qe, prob, 2, 4, 0,
                            torch.full((), 1e-4, device=dev))
    if name == "occupancy":
        from ground_fusion2_tpu_torch.mapping.occupancy import (
            GridConfig, scatter_scan)
        return scatter_scan(torch.zeros((400, 400), device=dev),
                            torch.zeros(2, device=dev),
                            torch.ones((4, 3), device=dev),
                            torch.ones(4, dtype=torch.bool, device=dev),
                            GridConfig())
    if name == "small_normal":
        from ground_fusion2_tpu_torch.config import VioConfig
        from ground_fusion2_tpu_torch.factors import vio_factors as fac
        x0, feats, layout, delta = checks.example_window(8, dev)
        meas = checks.example_measurements(x0, feats, layout, dev)
        return fac.small_normal_equations(x0, delta, meas, layout, VioConfig(
            num_feats=8, use_wheel=True, use_plane=True, use_motion=True))
    if name in ("brief", "simhash", "hamming"):
        from ground_fusion2_tpu_torch.posegraph import brief
        if name == "brief":
            return brief.brief_describe(torch.zeros((48, 64), device=dev),
                                        torch.zeros((4, 2), device=dev),
                                        torch.ones(4, device=dev))
        if name == "simhash":
            return brief.global_descriptor(torch.zeros((4, 256), device=dev),
                                           torch.ones(4, device=dev))
        w = torch.zeros((4, 8), dtype=torch.int32, device=dev)
        return brief.hamming(w, w)
    if name == "gnss_normal":
        from ground_fusion2_tpu_torch.config import VioConfig
        from ground_fusion2_tpu_torch.factors import vio_factors as fac
        x0, feats, layout, delta = checks.example_window(8, dev)
        x, meas = checks.example_gnss(
            x0, checks.example_measurements(x0, feats, layout, dev), layout,
            dev)
        return fac.small_normal_equations(x, delta, meas, layout, VioConfig(
            num_feats=8, use_gnss=True))
    if name == "global_normal":
        from ground_fusion2_tpu_torch.gnss import global_opt as go
        g = _global_graph(dev, 10, 16).graph.to(dev)
        return go.graph_normal_equations(g, torch.zeros(96, device=dev))
    if name in ("window_cost", "triangulate", "window_tests",
                "window_update"):
        from ground_fusion2_tpu_torch.config import VioConfig
        from ground_fusion2_tpu_torch.factors import vio_factors as fac
        from ground_fusion2_tpu_torch.vio import feature_window as fwm
        x0, feats, layout, delta = checks.example_window(8, dev)
        if name == "window_cost":
            meas = checks.example_measurements(x0, feats, layout, dev)
            return fac.window_cost_fn(x0, meas, layout,
                                      VioConfig(num_feats=8))(delta)
        fw = fwm.FeatureWindow(feats.ray, feats.vel, feats.obs_valid,
                               feats.obs_valid, feats.anchor,
                               feats.track_valid, feats.depth_fixed)
        if name == "triangulate":
            return fwm.triangulate(fw, x0, x0.rho)
        if name == "window_tests":
            return fwm.co_parallax(fw)
        return fwm.slide_oldest(fw, x0, x0.rho)
    if name in ("pg_cost", "global_cost"):
        if name == "pg_cost":
            from ground_fusion2_tpu_torch.posegraph import pose_graph as pgm
            args = checks.ring_graph_args(10, 64, dev)
            return pgm.pg_cost_fn(*args)(torch.zeros(256, device=dev))
        from ground_fusion2_tpu_torch.gnss import global_opt as go
        g = _global_graph(dev, 10, 16).graph.to(dev)
        return go.graph_cost_fn(g)(torch.zeros(96, device=dev))
    if name == "dyn_mask":
        from ground_fusion2_tpu_torch.frontend import dynamic
        z = torch.zeros((48, 64), device=dev)
        return dynamic.dynamic_mask(z, z, z, z, torch.eye(3), torch.zeros(3),
                                    (50.0, 50.0, 32.0, 24.0))
    if name in ("loop_geom", "pg_normal"):
        from ground_fusion2_tpu_torch.posegraph import pose_graph as pgm
        if name == "loop_geom":
            z = torch.zeros((16, 3), device=dev)
            return pgm.loop_geometry(z, z[:, :2], z, z[:, 0], z[:, 0], 0.08,
                                     torch.zeros((4, 16), device=dev))
        args = checks.ring_graph_args(10, 64, dev)
        return pgm.pg_normal_equations(*args, torch.zeros(256, device=dev))
    from ground_fusion2_tpu_torch.frontend.clahe import clahe
    from ground_fusion2_tpu_torch.lio import ct_icp, eskf, voxel_map as vm
    if name == "clahe":
        return clahe(torch.zeros((48, 64), device=dev))
    if name == "radix_sort":
        return vm.stable_argsort(torch.zeros(64, dtype=torch.int32, device=dev))
    if name in ("pyramid", "shi_tomasi", "detect_grid"):
        from ground_fusion2_tpu_torch.frontend import klt
        img = torch.zeros((48, 64), device=dev)
        if name == "pyramid":
            return klt.build_pyramid(img, 2)
        if name == "shi_tomasi":
            return klt.shi_tomasi(img)
        return klt.detect_grid(img, torch.zeros((4, 2), device=dev), 16, 4)
    if name == "ransac_f":
        from ground_fusion2_tpu_torch.frontend import ransac
        z = torch.zeros((16, 2), device=dev)
        return ransac.ransac_f_reject(z, z, torch.ones(16, device=dev),
                                      torch.zeros((4, 16), device=dev))
    if name == "preint":
        from ground_fusion2_tpu_torch.config import m3dgr_camera
        from ground_fusion2_tpu_torch.sensors.window_preint import (
            preintegrate_window)
        e = m3dgr_camera().estimator
        b = torch.zeros((2, 129, 3), device=dev)
        d = torch.zeros((2, 128), device=dev)
        one = torch.ones((), device=dev)
        q = torch.tensor([1.0, 0, 0, 0], device=dev)
        return preintegrate_window(b, b, b, d, d, b[:, 0], b[:, 0], one, one,
                                   one, e.imu_noise, e.wheel_noise, q)
    cfg = VoxelMapConfig(capacity=64)
    z3 = torch.zeros((8, 3), device=dev)
    if name == "lio_assoc":
        return vm.associate(vm.VoxelMap.empty(cfg, dev), z3, z3, cfg)
    s = eskf.EskfState.initial(device=dev)
    if name == "eskf_predict":
        z = torch.zeros(4, device=dev)
        return eskf.predict_final(s, z3[:4], z3[:4], z, z, EskfOptions())
    pose = ct_icp.CtPose(s.q, s.p, s.q, s.p)
    z = torch.zeros(8, device=dev)
    return ct_icp.normal_equations(pose, pose, z3, z, z3, z3, z,
                                   m3dgr_lio().icp_cfg)


def test_track_tail_kernel_matches_plain(dev, camera):
    """AH's lift, kill and tail modes bit for bit, at the configuration's
    and a distorted camera, the tail also with t = prev_t."""
    _, fv, fs, _ = camera
    r = checks.check_track_tail(dev, fs[12:14], fv.cam, fv.tcfg.depth_range,
                                timed=False)
    assert r["ok"], r


@pytest.mark.parametrize("name", ["hilti22", "idc", "Mei", "PinholeFull",
                                  "Scaramuzza"])
def test_track_tail_kernel_matches_plain_for_each_camera_model(dev, name):
    """AH's lift and tail modes bit for bit for every camera model (the
    loader's Equidistant and radtan Pinhole, tests/test_cameras.py's Mei,
    PinholeFull and Scaramuzza), over the whole image, twice the same
    bits."""
    r = checks.check_camera_models(dev, {name: checks.camera_cases()[name]},
                                   timed=False)
    assert r["ok"], r


def test_track_tail_kernel_refuses_an_unknown_camera(dev):
    from dataclasses import dataclass
    from ground_fusion2_tpu_torch.frontend import track_tail

    @dataclass(frozen=True)
    class Other:
        fx: float = 1.0
    with pytest.raises(ValueError, match="Other"):
        track_tail.lift_norm(Other(), torch.ones((4, 2), device=dev))


@pytest.mark.parametrize("rational", [True, False])
def test_calib_normal_kernel_matches_plain(dev, rational):
    """AP's H, g and cost against jacfwd + JᵀJ at δ = 0 and at a seeded δ
    on 12 views of a 12 × 8 board (checks.calib_tolerances), twice the same
    bits, its cost mode equal to its normal mode's cost; a count a call of
    each mode."""
    import numpy as np
    from ground_fusion2_tpu_torch.calib import intrinsics as ci
    obj, uv = checks.calib_views(rational, n_views=12)
    prob = ci.calib_problem(obj, uv, 12 if rational else 8, dev)
    rng = np.random.default_rng(3)
    step = torch.as_tensor(rng.normal(scale=1e-3, size=prob.dim),
                           dtype=torch.float32, device=dev)
    r = checks.check_calib(dev, prob, dict(zero=torch.zeros_like(step),
                                           seeded=step), timed=False)
    assert r["ok"], r
    _kernels.launches.clear()
    ci.normal_equations(prob, step)
    ci.cost_at(prob, step)
    assert _kernels.launches["calib_normal"] == 2


def test_calibration_on_the_card_meets_the_truth_gates(dev):
    """calibrate_pinhole_full on 40 views (D = 252, kernel W's cluster
    mode): rms < 0.1 px, fx fy cx cy within 1.5 px; AP, W and AN launch
    and jacfwd never runs."""
    from ground_fusion2_tpu_torch.calib import intrinsics as ci
    obj, uv = checks.calib_views(True)
    calls = []
    orig = torch.func.jacfwd
    torch.func.jacfwd = lambda *a, **k: calls.append(1) or orig(*a, **k)
    _kernels.launches.clear()
    try:
        res = ci.calibrate_pinhole_full(obj, uv, device=dev)
    finally:
        torch.func.jacfwd = orig
    assert res.rms_px < 0.1, res
    for k in ("fx", "fy", "cx", "cy"):
        assert abs(getattr(res, k) - checks.CALIB_RATIONAL[k]) < 1.5, res
    assert not calls
    # a count a call of each mode (two launches a call): the first cost,
    # a linearization and a trial cost an iteration, the last linearization
    assert _kernels.launches["calib_normal"] == 1 + 40 * 2 + 1
    assert _kernels.launches["chol_solve"] == 40
    assert _kernels.launches["lm_glue"] == 40


def test_noisy_calibration_on_the_card(dev):
    """calibrate_pinhole on 40 views with 0.3 px of noise (the JAX suite's
    gates: rms < 0.6 px, fx cx within 8 px), then AP against its plain
    version at δ = 0 and at the LM's final δ, where the cost (~300) sits
    far above float32 rounding."""
    from ground_fusion2_tpu_torch.calib import intrinsics as ci
    obj, uv = checks.calib_views(False, noise=0.3)
    res = ci.calibrate_pinhole(obj, uv, device=dev)
    assert 0.3 < res.rms_px < 0.6, res
    for k in ("fx", "cx"):
        assert abs(getattr(res, k) - checks.CALIB_RADTAN[k]) < 8.0, res
    prob = ci.calib_problem(obj, uv, 8, dev)
    lm = ci.solve(prob, 30)
    r = checks.check_calib(dev, prob, dict(
        zero=torch.zeros(prob.dim, device=dev), final=lm.delta), timed=False)
    assert r["ok"], r


def test_window_carry_kernel_matches_plain(dev, camera):
    """AI's write at two columns and its slide in every branch, past M
    samples too, bit for bit."""
    _, fv, fs, _ = camera
    r = checks.check_window_carry(dev, fv, fs[-1], timed=False)
    assert r["ok"], r


def test_marg_schur_kernel_matches_plain(dev, camera):
    """AJ around X: both marginalizations' priors bit for bit."""
    _, fv, _, _ = camera
    r = checks.check_marg_schur(dev, fv, timed=False)
    assert r["ok"], r


def test_glue_kernels_launch_a_tick(dev, camera):
    """A fused tick with the window full: AH twice (lift, tail), AI twice
    (write, slide), AJ ten times (both marginalizations, each on its
    branch), AN once a solve's pack and retraction (its 8 steps run in
    S's last CTA) and once each MARGIN_OLD's pack and MARGIN_SECOND_NEW's
    weigh, AO four times
    (the upload's conversions, the tracked mask with RANSAC's noise, pre,
    post), AQ once (the frame's draw and next index, RANSAC on or off)."""
    import copy
    cfg, fv, fs, _ = camera
    fv2 = copy.copy(fv)
    f = fs[-1]
    _kernels.launches.clear()
    fv2.process_image(f["t"] + 0.1, f["gray"], f["depth"], f["imu"],
                      wheel_vel=f["wheel"])
    got = {k: _kernels.launches[k] for k in ("track_tail", "window_carry",
                                              "marg_schur", "lm_glue",
                                              "tick_glue", "threefry")}
    full = fv.frame_count >= checks.NUM_FRAMES
    assert got == dict(track_tail=2, window_carry=2,
                       marg_schur=10 if full else 0,
                       lm_glue=2 + (2 if full else 0),
                       tick_glue=4, threefry=1), got


def test_lm_glue_kernel_matches_plain(dev, camera):
    """AN's pack (a tick's, stationary with no prior, MARGIN_OLD's), L's
    reduce adding C's block, the step (accept, reject, tie, NaN cost, λ at
    both clamps, in place), the retraction (a solve's step, zero, tiny and
    large rotations) and the weigh, bit for bit."""
    _, fv, _, _ = camera
    r = checks.check_lm_glue(dev, fv, timed=False)
    assert r["ok"], {k: v for k, v in r["modes"].items() if not v["ok"]}


def test_tick_glue_kernel_matches_plain(dev, camera):
    """AO's unpack (a 640 × 480 frame and an odd-sized one), track (the
    tracked mask, the Gumbel noise), pre (the new column last and in the
    middle) and post (with and without an anomaly, the GNSS gate both ways,
    a middle column), bit for bit."""
    _, fv, _, _ = camera
    r = checks.check_tick_glue(dev, fv, timed=False)
    assert r["ok"], r


def test_device_slide_equals_the_host_slide_and_skips_off_branch(dev, camera):
    """The prior and window slid by the keyframe flag on the device equal
    MARGIN_OLD's and MARGIN_SECOND_NEW's alone; AN's pack and weigh, C, L,
    X and AJ off their branch leave sentinel-filled outputs untouched and
    on it give the unpredicated call's bits."""
    _, fv, _, _ = camera
    r = checks.check_device_slide(dev, fv, timed=False)
    assert r["ok"], r


def test_solve_window_launches_at_most_90_activities(dev, camera):
    """The window solve: the linearizations (9), W and S an iteration (8,
    S's last CTA taking AN's step), S's first cost, AN's pack and the
    retraction make 82 CUDA activities on an H100; ≤ 84, so that AN's
    eight steps split out again under any kernel name fail, and none of
    them is AN's standalone step."""
    from ground_fusion2_tpu_torch.vio import problem
    _, fv, _, _ = camera
    meas = checks.carry_measurements(fv)
    t = checks.device_ms(lambda: problem.solve_window(
        fv.carry.state, meas, fv.layout, fv.cfg.vio), reps=3)
    assert t.launches <= 84, (t.launches, sorted(t.kernels))
    assert not any("lm_step_kernel" in k for k in t.kernels), t.kernels


def test_ct_glue_kernel_matches_plain(dev, lio):
    """AK's points (keypoints, scan), weights and step (from 0, frozen, at
    the midpoint with and without a re-gather) bit for bit."""
    lo, _, x = lio
    r = checks.check_ct_glue(dev, x, lo.cfg.icp_cfg, lo.cfg.map_cfg,
                             timed=False)
    assert r["ok"], r


def test_voxel_glue_kernel_matches_plain(dev, lio):
    """AL's every mode bit for bit; an insert, an overflowing insert, a
    recenter and an eviction on the card equal to the CPU's."""
    lo, _, x = lio
    r = checks.check_voxel_glue(dev, x, lo.cfg.map_cfg, lo.cfg, timed=False)
    assert r["ok"], r


@pytest.mark.parametrize("Q", checks.FOLD_QUERIES)
def test_ct_fold_association_equals_ak_then_d(dev, lio, Q):
    """Kernel D's CT-ICP entry (the keypoints' transform in its prologue,
    AK's weights in its epilogue) against AK's points, D's plain entry and
    AK's weights, bit for bit in every mode, at Q keypoints."""
    lo, _, x = lio
    r = checks.check_ct_fold(dev, x, lo.cfg.icp_cfg, lo.cfg.map_cfg,
                             timed=False, queries=(Q,))
    assert len(r["assoc"]) == 4 and all(
        v["equal"] for v in r["assoc"].values()), r


def test_ct_fold_step_equals_ak_step(dev, lio):
    """Kernel E's step tail against E with the solve then AK's step, bit
    for bit: from done = 0, frozen, at the midpoint with and without a
    re-gather, and on a NaN step."""
    lo, _, x = lio
    r = checks.check_ct_fold(dev, x, lo.cfg.icp_cfg, lo.cfg.map_cfg,
                             timed=False, queries=())
    assert r["ok"], r


@pytest.mark.parametrize("F", [1, 150, 257])
def test_window_tests_kernel_at_track_counts(dev, camera, F):
    """Kernel U's two modes against the plain versions on the fused window
    cut to one track or its tracks repeated to F (F·W projections over the
    block's threads, the chains past one warp's stride), at the tick's
    outlier gate and at 0.5 px."""
    _, fv, _, _ = camera
    fw, st, _, interval = checks.window_stage_inputs(fv)
    n = fw.obs_valid.shape[0]
    idx = torch.arange(F, device=dev) % n
    fw = fw._replace(**{k: v[idx] for k, v in fw._asdict().items()
                        if torch.is_tensor(v) and v.dim() and v.shape[0] == n})
    st = st._replace(rho=st.rho[idx])
    W = fw.obs_valid.shape[1]
    stationary = torch.zeros((), dtype=torch.bool, device=dev)
    for px in (fv.statics.outlier_px, 0.5):
        r = checks.check_window_tests(dev, fw, st, fv.statics._replace(
            outlier_px=px), stationary, interval, W - 2, timed=False)
        assert r["ok"], (px, r)


def test_lio_update_kernel_matches_plain_through_the_switch(dev, lio):
    """AM bit for bit through the scripted switch sequence: every switch
    branch, every observe select, the recenter predicate both ways."""
    import chip_smoke
    lo, _, x = lio
    r = checks.check_lio_update(dev, x, chip_smoke.lio_rc_thresh(lo),
                                timed=False)
    assert r["ok"] and r["all_branches"], r


@pytest.mark.parametrize("kernel", ["ct_glue", "voxel_glue", "lio_update"])
def test_lidar_glue_kernels_launch_a_tick(dev, kernel):
    """A fused LiDAR tick: AK once (the scan; the keypoints' transform and
    the weights run in kernel D, the steps in kernel E), AL 9 (3 keypoint modes, 6 insert modes; 2 more on a
    recenter or an eviction), AM once, and kernel Y's inverse entry no
    time (AM runs its device code)."""
    from ground_fusion2_tpu_torch.lio.odometry import LidarOdometry
    scans = checks.lidar_drive(6, z=1.0)
    lo = LidarOdometry(m3dgr_lio(), device=dev)
    for s in scans[:5]:
        lo.process_scan(s["t"], s["pts"], s["alpha"], s["valid"], s["imu"])
    _kernels.launches.clear()
    s = scans[5]
    lo.process_scan(s["t"], s["pts"], s["alpha"], s["valid"], s["imu"])
    got = _kernels.launches[kernel]
    want = dict(ct_glue=1, voxel_glue=9, lio_update=1)[kernel]
    assert got == want, dict(_kernels.launches)
    assert _kernels.launches["spd_inverse"] == 0


def test_mesh_and_grid_on_the_card_equal_the_plain_route(dev):
    """Fault 2's bound: fed the same sweeps (the system drive's clouds at
    their true poses, each textured by its frame at the true camera pose),
    the card's mesh (AA, AB, AC) and occupancy grid (Z) give the plain
    route's figures exactly: vertices, meshed voxels, triangles, textured
    vertices, occupied and free cells. Fed the JAX package's own inputs on
    phases 13 and 14's drive, both give JAX's textured share and grid
    exactly and its triangles once JAX's eigenvectors take the port's sign
    convention (tests/torch_mesh_chain.py); the card alone parts from JAX
    only through its inputs (ROADMAP.md, known sources of divergence)."""
    import numpy as np
    from ground_fusion2_tpu_torch.data import synthetic as sim
    from ground_fusion2_tpu_torch.mapping.occupancy import (GridConfig,
                                                            OccupancyGrid)
    from ground_fusion2_tpu_torch.mesh import incremental as mi
    intr = (160.0, 160.0, 80.0, 60.0)
    frames = checks.system_drive(6, W=160, H=120, intrinsics=intr,
                                 n_rays=1024)
    cfg = mi.MeshConfig(capacity=1 << 14, insert_chunk=1024, cand=16)

    def run(device):
        mesher = mi.OnlineMesher(cfg, intrinsics=intr, device=device)
        grid = OccupancyGrid(GridConfig(), device)
        for f in frames:
            R = np.asarray(sim._quat_to_mat(f["q_gt"]))
            pw = (f["pts"] @ R.T + f["p_gt"]).astype(np.float32)
            m = f["valid"].astype(np.float32)
            img = np.repeat(f["gray"].astype(np.float32)[:, :, None], 3, 2)
            mesher.add_frame(pw, m, image=img,
                             r_wc=(R @ checks.RIG_RIC).astype(np.float32),
                             t_wc=f["p_cam"].astype(np.float32))
            grid.update(f["p_gt"][:2], pw, m > 0.5)
        st = mesher.stats()
        code = mesher.mesh.code.cpu().numpy()
        textured = int((mesher.mesh.w.cpu().numpy()[code != mi.INVALID]
                        > 0).sum())
        p = grid.prob()
        return dict(st, textured=textured, occupied=int((p > 0.65).sum()),
                    free=int((p < 0.2).sum()))
    card, plain = run(dev), run("cpu")
    assert card["triangles"] > 0 and card["textured"] > 0, card
    assert card == plain


@pytest.mark.parametrize("name", ["clahe", "lio_assoc", "ct_icp_normal",
                                  "radix_sort", "eskf_predict", "preint",
                                  "pyramid", "shi_tomasi", "detect_grid",
                                  "ransac_f", "small_normal", "brief",
                                  "simhash", "hamming", "loop_geom",
                                  "pg_normal", "gnss_normal", "global_normal",
                                  "dyn_mask", "window_cost", "triangulate",
                                  "window_tests", "window_update", "pg_cost",
                                  "global_cost", "chol_solve", "sym_eig",
                                  "sqrt_info", "spd_inverse", "icp_solve",
                                  "degeneracy", "occupancy", "mesh_insert",
                                  "mesh_rgb", "mesh_delaunay", "line_detect",
                                  "line_refit", "dist_schur", "map_schur",
                                  "track_tail", "window_carry", "marg_schur",
                                  "ct_glue", "voxel_glue", "lio_update",
                                  "calib_normal", "threefry"])
def test_cuda_tensor_never_takes_the_plain_path(dev, monkeypatch, name):
    """A failed launch raises; nothing falls back to the plain version."""
    monkeypatch.setattr(_kernels, "check", lambda err, name: (_ for _ in ()).throw(
        RuntimeError(f"{name}: forced failure")))
    with pytest.raises(RuntimeError, match="forced failure"):
        _launch(name, dev)


def test_threefry_kernel_matches_plain_and_jax(dev):
    """AQ's tick draw (a device word, and the next word), a seed's Gumbel
    noise and the loop's split keys and noise, each bit for bit its plain
    route and jax 0.9.0's recorded answers, twice the same bits."""
    r = checks.check_threefry(dev, timed=False)
    assert r["ok"], r


@pytest.mark.parametrize("mode", ["tick", "gumbel", "split", "word"])
def test_threefry_one_launch_a_draw(dev, mode):
    from ground_fusion2_tpu_torch.core import prng
    word = torch.full((), 7, dtype=torch.int32, device=dev)
    fn = dict(tick=lambda: prng.tick_uniforms(word, 64, 150),
              word=lambda: prng.tick_uniforms(word, 0, 150),
              gumbel=lambda: prng.gumbel_noise(7, 64, 150, dev),
              split=lambda: prng.split_gumbel(7, 128, 150, dev))[mode]
    t = checks.device_ms(fn, reps=5)
    assert t.launches == 1, t


def test_threefry_tick_word_is_read_on_the_device(dev):
    """The tick's draw reads its key from the word: the launches are the
    same for every frame, and the word's value (not the launch) picks the
    noise."""
    from ground_fusion2_tpu_torch.core import prng
    w = torch.full((), 3, dtype=torch.int32, device=dev)
    a, n1 = prng.tick_uniforms(w, 64, 150)
    w.fill_(4)
    b, n2 = prng.tick_uniforms(w, 64, 150)
    assert torch.equal(a, prng.uniform(prng.key(3, dev), (64, 150)))
    assert torch.equal(b, prng.uniform(prng.key(4, dev), (64, 150)))
    assert int(n1) == 4 and int(n2) == 5
    u, n3 = prng.tick_uniforms(w, 0, 150)     # a tick without RANSAC
    assert tuple(u.shape) == (0, 150) and int(n3) == 5


@pytest.fixture(scope="module")
def stereo(dev):
    return checks.stereo_window(150, dev), checks.stereo_config(150)


def test_stereo_rows_in_kernel_c_match_plain(dev, stereo):
    sw, cfg = stereo
    r = checks.check_proj(dev, sw["x0"], sw["feats"], sw["layout"],
                          sw["delta"], cfg.proj_sqrt_info, timed=False,
                          stereo=sw["stereo"])
    assert r["ok"], r


def test_stereo_rows_in_kernel_s_match_plain(dev, stereo):
    sw, cfg = stereo
    zero = torch.zeros(sw["layout"].dim, device=dev)
    step = checks.lm_trial(sw["x0"], sw["meas"], sw["layout"], cfg)
    r = checks.check_window_cost(dev, sw["x0"], sw["meas"], sw["layout"], cfg,
                                 dict(zero=zero, step=step, back=-step),
                                 timed=False)
    assert r["ok"], r


def test_stereo_off_is_the_mono_launch(dev, stereo):
    """The stereo inputs present but use_stereo clear: C and S give the
    bits of the measurements without them."""
    from ground_fusion2_tpu_torch.factors import vio_factors as fac
    sw, cfg = stereo
    mono = cfg._replace(use_stereo=False)
    bare = sw["meas"]._replace(stereo_ray=None, stereo_valid=None)
    a = fac.projection_normal_equations(sw["x0"], sw["delta"], sw["feats"],
                                        sw["layout"], cfg.proj_sqrt_info)
    b = fac.projection_normal_equations(sw["x0"], sw["delta"], sw["feats"],
                                        sw["layout"], cfg.proj_sqrt_info,
                                        stereo=None)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    c1 = fac.window_cost_fn(sw["x0"], sw["meas"], sw["layout"], mono)(
        sw["delta"])
    c2 = fac.window_cost_fn(sw["x0"], bare, sw["layout"], mono)(sw["delta"])
    assert torch.equal(c1, c2)


def test_stereo_solve_on_the_card(dev, stereo):
    """solve_window and marginalize_oldest with use_stereo: positions under
    tests/test_window_ba.py's 0.01 m of the truth, C and S launched, a
    finite prior."""
    from ground_fusion2_tpu_torch.vio import problem
    sw, cfg = stereo
    _kernels.launches.clear()
    out = problem.solve_window(sw["x0"], sw["meas"], sw["layout"], cfg)
    prior = problem.marginalize_oldest(out.state, sw["meas"], sw["layout"],
                                       cfg)
    err = float((out.state.p - sw["p_true"]).norm(dim=-1).max())
    assert err < 0.01, err
    assert _kernels.launches["proj_normal"] > 0
    assert _kernels.launches["window_cost"] > 0
    assert bool(torch.isfinite(prior.sqrt_J).all())


def test_folded_conversions_equal_torchs(dev, camera):
    """The camera tick's conversions folded into kernels: U's flags equal
    torch's ``out > 0.5`` of its floats, H's sum_dt torch's sum of its
    rows, Y on H's covariances in place equal to Y on their copies."""
    from ground_fusion2_tpu_torch.vio.state import NUM_FRAMES
    cfg, fv, _, _ = camera
    fw, st, _, interval = checks.window_stage_inputs(fv)
    W = fw.obs_valid.shape[1]
    r = checks.check_window_tests(dev, fw, st, fv.statics, torch.zeros(
        (), dtype=torch.bool, device=dev), interval, W - 2)
    assert r["folded_flags_equal"], r
    p = checks.check_preint(dev, checks.preint_inputs(
        fv.carry, fv.statics, cfg.estimator.imu_noise,
        cfg.estimator.wheel_noise, NUM_FRAMES - 1), timed=False)
    assert p["ok"] and p["glue_equal"]["sum_dt"], p
    assert p["glue_equal"]["sqrt_info in place"], p


@pytest.mark.parametrize("case", ["the final window",
                                  "an interval with no valid sample",
                                  "a covariance not positive definite"])
def test_preint_sqrt_fold_equals_h_then_y(dev, camera, case):
    """Kernel H with Y's square-root informations in its blocks is bit for
    bit H, then Y's standalone entry on both covariances: on phase 4's
    window, with an interval of no valid sample, and where the IMU
    covariance is not positive definite (Y's pivot rule)."""
    _, fv, _, _ = camera
    r = checks.check_sqrt_fold(checks.sqrt_fold_cases(dev, fv)[case])
    assert all(r["equal"].values()), r
    if case == "a covariance not positive definite":
        assert r["not_pd"] > 0, r


@pytest.mark.parametrize("n", [15, 6, "inverse 6"])
def test_sqrt_info_register_form_matches_plain(dev, n):
    """Y's entry 1 in its register form (n = 15 and 6) against the plain
    route and float64 at checks.py's tolerance, on kernel H's covariances
    of seeded intervals, and its inverse mode (kernel AM's) on their 6×6
    wheel covariances."""
    from ground_fusion2_tpu_torch.sensors import window_preint as wp
    x = checks.preint_case(dev)
    pre, wpre, _ = wp.preintegrate_window(*x["args"], prop=x["prop"])
    if n == "inverse 6":
        r = checks._check_spd_inverse(dev, wpre.cov, timed=False)
    else:
        cov = {15: pre.cov, 6: wpre.cov}[n]
        r = checks._check_sqrt_info(dev, {f"n = {n}": cov}, timed=False)
    assert r["ok"], r


@pytest.mark.parametrize("inverse", [False, True])
def test_sqrt_info_refuses_other_sizes(dev, inverse):
    """Y's entry 1 takes n = 15 and 6 only: at n = 9 the wrapper raises and
    the C entry returns cudaErrorInvalidValue without a launch."""
    import ctypes
    from ground_fusion2_tpu_torch.solver.small_linalg import small_spd_cuda
    A = torch.eye(9, device=dev).expand(2, 9, 9).contiguous()
    _kernels.launches.clear()
    with pytest.raises(ValueError, match="n = 15 or 6"):
        small_spd_cuda(A, inverse=inverse)
    out = torch.empty_like(A)
    err = _kernels.library().gf2_sqrt_info(
        ctypes.c_void_p(A.data_ptr()), 2, 9, 81, int(inverse),
        ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    assert err == 1, err                    # cudaErrorInvalidValue
    assert not _kernels.launches, dict(_kernels.launches)


@pytest.mark.parametrize("rows", ["mono", "stereo"])
def test_window_cost_step_equals_s_then_an(dev, window, stereo, rows):
    """Kernel S with AN's step in its last CTA is bit for bit S, then AN's
    standalone step (δ, the cost and λ), mono and stereo, through
    ``checks.FOLD_STEPS``: an accept, a reject, a tie, a NaN cost and λ at
    each clamp, each taken or refused as designed."""
    if rows == "mono":
        x0, _, layout, _, meas, vcfg = window
    else:
        sw, vcfg = stereo
        x0, meas, layout = sw["x0"], sw["meas"], sw["layout"]
    r = checks.check_step_fold(x0, meas, layout, vcfg)
    for name, (_, _, ratio) in checks.FOLD_STEPS.items():
        assert all(r[name]["equal"].values()), (name, r[name])
        assert r[name]["accepted"] == (ratio is not None and ratio > 1.0), r
