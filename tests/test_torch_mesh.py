"""Parity of the port's online mesh (``ground_fusion2_tpu_torch/mesh``) with
the JAX package's, on the CPU, at small sizes: stores of 64–8,192 rows,
chunks of 256–1,024, the JAX tests' ``_floor_points`` scenes and a few
frames of ``checks.system_drive`` at 384 rays and 160×120 pixels; the
inputs made with numpy from seeds and handed to both packages.

Measured on a CPU: ``insert`` gives the JAX store bit for bit (codes, vids,
positions, colours, weights, evicted codes); ``update_rgb`` the same mask,
colours, weights and distances; ``retriangulate`` the same triangles, voxel
by voxel, once the JAX package's eigenvectors are put into the port's sign
convention. Without that convention the two differ on triangles whose
circumcircle test the vid-hash jitter decides: the jitter is added in plane
coordinates, and LAPACK's eigenvector signs (which no port reproduces)
reflect it in about half the voxels (seed 0's floor: 12 of 417 triangles).
So the comparisons below run the JAX package's ``_delaunay_one`` with its
``eigh`` wrapped to apply the convention (largest component positive, ties
to the lower axis), through a stand-in for the JAX mesh module's ``jnp``
that is installed for one test and removed after it, with the jitted
programs' caches cleared around it; nothing of the JAX package changes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ground_fusion2_tpu.lio import voxel_map as jvm
from ground_fusion2_tpu.mesh import export as jexport
from ground_fusion2_tpu.mesh import incremental as jim
from ground_fusion2_tpu_torch import checks, convert
from ground_fusion2_tpu_torch.data import synthetic as sim
from ground_fusion2_tpu_torch.lio import voxel_map as tvm
from ground_fusion2_tpu_torch.mesh import export as texport
from ground_fusion2_tpu_torch.mesh import incremental as tim

torch.set_num_threads(1)
INVALID = tim.INVALID
STORE_FIELDS = ("pts", "rgb", "w", "pw", "obs_dist", "vid", "code")


def _floor_points(rng, extent=1.8, n=400, z=0.0, noise=5e-3):
    """tests/test_mesh_incremental.py's scene."""
    pts = np.zeros((n, 3), np.float32)
    pts[:, 0] = rng.uniform(-extent / 2, extent / 2, n)
    pts[:, 1] = rng.uniform(-extent / 2, extent / 2, n)
    pts[:, 2] = z + rng.normal(0, noise, n)
    return pts


def _tcfg(cfg):
    return convert.mesh_config_from_jax(cfg)


def _assert_store_equal(tm, jm, rgb_tol=0.0):
    """Equal stores; the colours within ``rgb_tol`` (XLA contracts the
    bilinear blend into FMAs on the CPU, the port rounds each product)."""
    for f in STORE_FIELDS:
        a, b = getattr(tm, f).numpy(), np.asarray(getattr(jm, f))
        if f == "rgb":
            np.testing.assert_allclose(a, b, rtol=0, atol=rgb_tol, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert tm.next_vid == int(np.asarray(jm.next_vid))


def _eigh_convention(a, *args, **kwargs):
    """JAX's eigh with each eigenvector signed as the port signs it."""
    w, v = jnp.linalg.eigh(a, *args, **kwargs)
    idx = jnp.argmax(jnp.abs(v), axis=-2)
    big = jnp.take_along_axis(v, idx[..., None, :], axis=-2)
    return w, v * jnp.where(big < 0, -1.0, 1.0).astype(v.dtype)


class _Delegate:
    """``base``'s attributes, but those given."""

    def __init__(self, base, **own):
        self._base = base
        self.__dict__.update(own)

    def __getattr__(self, name):
        return getattr(self._base, name)


# jax.numpy for the JAX mesh module, but for linalg.eigh
_JNP_WITH_CONVENTION = _Delegate(jnp, linalg=_Delegate(
    jnp.linalg, eigh=_eigh_convention))


@pytest.fixture
def sign_convention(monkeypatch):
    jim.retriangulate.clear_cache()
    monkeypatch.setattr(jim, "jnp", _JNP_WITH_CONVENTION)
    yield
    jim.retriangulate.clear_cache()


# ------------------------------------------------------------------ insert
@pytest.mark.parametrize("case", ["two_inserts", "reinsert", "overflow"])
def test_insert_matches_jax(rng, case):
    """Two inserts of different floor patches; the same points inserted
    twice (no new vertex, no eviction, the ids kept); the capacity-64
    overflow of test_mesh_incremental.py:145, chunk by chunk. The stores
    and the evicted codes are equal, positions bit for bit."""
    if case == "overflow":
        cfg = jim.MeshConfig(capacity=64, insert_chunk=256, max_per_voxel=12)
        pts = _floor_points(rng, extent=4.0, n=1024)
        chunks = [pts[i:i + 256] for i in range(0, 1024, 256)]
    else:
        cfg = jim.MeshConfig(capacity=2048, insert_chunk=512)
        a = _floor_points(rng, n=512)
        b = a if case == "reinsert" else _floor_points(rng, n=512) + [1.0, 0, 0]
        chunks = [a, b.astype(np.float32)]
    jm, tm = jim.MeshMap.empty(cfg), tim.MeshMap.empty(_tcfg(cfg), device="cpu")
    evicted = 0
    for p in chunks:
        m = np.ones(p.shape[0], np.float32)
        m[::7] = 0.0                                   # some rows masked out
        jm, jev = jim.insert(jm, jnp.asarray(p), jnp.asarray(m), cfg)
        tm, tev = tim.insert(tm, torch.as_tensor(p), torch.as_tensor(m),
                             _tcfg(cfg))
        _assert_store_equal(tm, jm)
        np.testing.assert_array_equal(tev.numpy(), np.asarray(jev))
        evicted += int((tev != INVALID).sum())
    live = int((tm.code != INVALID).sum())
    if case == "overflow":
        assert evicted > 0 and live == 64
    elif case == "reinsert":
        assert evicted == 0 and live > 50


def test_insert_pass_counts_surviving_rows():
    """The cap ranks a voxel's surviving rows: a voxel holding 12 vertices
    takes a re-insert of the same 12 points with no eviction, where
    counting raw rows would evict half of them."""
    cfg = tim.MeshConfig(capacity=64, insert_chunk=12)
    g = (np.arange(12) + 0.5) / 16.0
    pts = np.stack([g, (np.arange(12) % 4 + 0.5) / 8.0, np.full(12, 0.01)],
                   -1).astype(np.float32)
    m = torch.ones(12)
    tm, _ = tim.insert(tim.MeshMap.empty(cfg, device="cpu"),
                       torch.as_tensor(pts), m, cfg)
    vids = set(tm.vid[tm.code != INVALID].tolist())
    tm2, ev = tim.insert(tm, torch.as_tensor(pts), m, cfg)
    assert len(vids) == 12 and bool((ev == INVALID).all())
    assert set(tm2.vid[tm2.code != INVALID].tolist()) == vids


# -------------------------------------------------------------- update_rgb
def test_update_rgb_matches_jax(rng):
    """test_mesh_incremental.py:94's scene (a camera 2 m above the floor
    looking straight down), two views of different colours, then a view
    3x farther (the occlusion gate): each time the visibility mask equal,
    the colour within 1e-3, weights and distances equal."""
    cfg = jim.MeshConfig(capacity=2048, insert_chunk=512)
    intr = np.array([200.0, 200.0, 120.0, 90.0], np.float32)
    pts = _floor_points(rng, extent=1.0, n=512)
    jm, _ = jim.insert(jim.MeshMap.empty(cfg), jnp.asarray(pts),
                       jnp.ones((512,)), cfg)
    tm = convert.mesh_map_from_jax(jm, "cpu")
    r_wc = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)
    seen = 0
    for rgb, z in (((210.0, 40.0, 0.0), 2.0), ((10.0, 240.0, 90.0), 2.0),
                   ((0.0, 0.0, 200.0), 6.0)):
        img = np.zeros((180, 240, 3), np.float32)
        img[:] = rgb
        img[::3, ::5, 1] += 7.0                        # a texture to sample
        t_wc = np.array([0.05, -0.02, z], np.float32)
        w0 = np.asarray(jm.w)
        jm = jim.update_rgb(jm, jnp.asarray(img), jnp.asarray(intr),
                            jnp.asarray(r_wc), jnp.asarray(t_wc), cfg)
        tm, vis = tim.update_rgb(tm, torch.as_tensor(img), intr, r_wc, t_wc,
                                 _tcfg(cfg), with_vis=True)
        jvis = np.asarray(jm.w) > w0
        np.testing.assert_array_equal(vis.numpy(), jvis)
        np.testing.assert_allclose(tm.rgb.numpy(), np.asarray(jm.rgb),
                                   atol=1e-3, rtol=0)
        np.testing.assert_array_equal(tm.w.numpy(), np.asarray(jm.w))
        np.testing.assert_array_equal(tm.obs_dist.numpy(),
                                      np.asarray(jm.obs_dist))
        seen = max(seen, int(jvis.sum()))
    assert seen > 50 and not jvis.any()      # the far view is gated


# ---------------------------------------------------------- retriangulate
def _scene(seed):
    """Seed 0: the floor of test_retriangulate_covers_flat_floor; 1: the
    same patch tilted 37° about x; 2: a floor meeting a wall."""
    rng = np.random.default_rng(seed)
    pts = _floor_points(rng, extent=1.8, n=1024)
    if seed == 1:
        c, s = 0.8, 0.6
        pts = pts @ np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32).T
    if seed == 2:
        wall = _floor_points(rng, extent=1.8, n=512)
        wall = np.stack([wall[:, 0], wall[:, 2] + 0.9,
                         wall[:, 1] + 0.9], -1)
        pts = np.concatenate([pts[:512], wall])
    return pts.astype(np.float32)


def _dirty(mesh_code, cfg):
    """Every live voxel and its 6 face neighbours, padded to dirty_batch."""
    live = np.unique(mesh_code[mesh_code != INVALID])
    ijk = np.stack([(live & 1023) - 512, ((live >> 10) & 1023) - 512,
                    ((live >> 20) & 1023) - 512], -1)
    nb = (ijk[:, None] + tim.FACE_NBR[None]).reshape(-1, 3) + 512
    codes = np.unique(nb[:, 0] | (nb[:, 1] << 10) | (nb[:, 2] << 20))
    pad = (-len(codes)) % cfg.dirty_batch
    return np.concatenate([codes, np.full(pad, INVALID)]).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_retriangulate_matches_jax(sign_convention, seed):
    """Every voxel of the store and its neighbours, in batches of 32: the
    triangle sets equal, voxel by voxel, as sets of sorted vid triples."""
    cfg = jim.MeshConfig(capacity=4096, insert_chunk=1024)
    pts = _scene(seed)
    jm, _ = jim.insert(jim.MeshMap.empty(cfg), jnp.asarray(pts),
                       jnp.ones((pts.shape[0],)), cfg)
    tm = convert.mesh_map_from_jax(jm, "cpu")
    codes = _dirty(np.asarray(jm.code), cfg)
    n_tri = 0
    for s in range(0, len(codes), cfg.dirty_batch):
        c = codes[s:s + cfg.dirty_batch]
        jv, jk = (np.asarray(x) for x in jim.retriangulate(
            jm, jnp.asarray(c), cfg))
        tv, tk = (x.numpy() for x in tim.retriangulate(
            tm, torch.as_tensor(c), _tcfg(cfg)))
        for i in range(len(c)):
            want = {tuple(sorted(t)) for t in jv[i][jk[i]].tolist()}
            got = {tuple(sorted(t)) for t in tv[i][tk[i]].tolist()}
            assert got == want, (seed, int(c[i]), got ^ want)
            n_tri += len(want)
    assert n_tri > 100


def test_plane_basis_matches_jax_eigh():
    """The Jacobi basis against JAX's eigh under the convention on the
    covariances of floors, walls and tilted patches of 32 points: each
    vector within 1e-5 where its eigenvalue stands 1 % clear of the
    others."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(-0.5, 0.5, (300, 32, 3)).astype(np.float32)
    pts[:, :, 2] *= 0.02
    for k in range(300):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        pts[k] = pts[k] @ q.T.astype(np.float32)
    mask = torch.ones((300, 32), dtype=torch.bool)
    mask[::5, 20:] = False
    t = torch.as_tensor(pts)
    _, e1, e2 = tim.plane_basis(t, mask)
    wm = mask.numpy().astype(np.float32)[..., None]
    mean = (pts * wm).sum(1) / wm.sum(1)
    d = (pts - mean[:, None]) * wm
    cov = np.einsum("bki,bkj->bij", d, d) / wm.sum(1)[..., None]
    w, v = _eigh_convention(jnp.asarray(cov))
    w, v = np.asarray(w), np.asarray(v)
    for e, col in ((e1, 2), (e2, 1)):
        got = torch.stack(e, -1).numpy()
        gap = np.minimum(np.abs(w[:, col] - w[:, (col + 1) % 3]),
                         np.abs(w[:, col] - w[:, (col + 2) % 3]))
        clear = gap > 0.01 * w[:, 2]
        assert clear.mean() > 0.9
        np.testing.assert_allclose(got[clear], v[clear, :, col], atol=1e-5)


def test_jitter_hash_matches_jax():
    """h = uint32(vid)·2654435761 mod 2³² and the two 10-bit jitters, on
    small, large and negative (empty-row) vids."""
    vids = np.array([[0, 1, 7, 65535, 65536, 2**31 - 1, -1, -12345]],
                    np.int32)
    j1, j2 = tim._hash_jitter(torch.as_tensor(vids), torch.tensor(1.0))
    h = jnp.asarray(vids).astype(jnp.uint32) * jnp.uint32(2654435761)
    w1 = ((h >> 8) & 1023).astype(jnp.float32) / 1023.0 - 0.5
    w2 = ((h >> 18) & 1023).astype(jnp.float32) / 1023.0 - 0.5
    np.testing.assert_array_equal(j1.numpy(), np.asarray(w1))
    np.testing.assert_array_equal(j2.numpy(), np.asarray(w2))


# ---------------------------------------------------- OnlineMesher, export
MESH_DRIVE = dict(n=4, W=160, H=120, n_rays=384)
DRIVE_INTR = (152.0, 152.0, 80.0, 60.0)


@pytest.fixture(scope="module")
def drive():
    """A few frames of the system drive: each sweep's cloud in the world
    at the true pose, and its rendered frame as the texture at the true
    camera pose (as data/m3dgr_sim.py:392-404 feeds the mesh)."""
    out = []
    for f in checks.system_drive(MESH_DRIVE["n"], W=MESH_DRIVE["W"],
                                 H=MESH_DRIVE["H"], intrinsics=DRIVE_INTR,
                                 n_rays=MESH_DRIVE["n_rays"]):
        R = np.asarray(sim._quat_to_mat(f["q_gt"]))
        p_w = (f["pts"] @ R.T + f["p_gt"]).astype(np.float32)
        img = np.repeat(f["gray"].astype(np.float32)[:, :, None], 3, axis=2)
        out.append(dict(pts=p_w, mask=f["valid"].astype(np.float32),
                        image=img, r_wc=(R @ checks.RIG_RIC).astype(np.float32),
                        t_wc=np.asarray(f["p_cam"], np.float32)))
    return out


# 16 candidates a voxel (C(16, 3) = 560 triples; the default 32 gives 4,960,
# which the plain version's dense tests take ~15 s a drive to evaluate on
# one CPU thread): test_retriangulate_matches_jax holds the default
MESHER_CFG = jim.MeshConfig(capacity=8192, insert_chunk=1024, cand=16)


def _feed(mesher, f):
    mesher.add_frame(f["pts"], f["mask"], image=f["image"], r_wc=f["r_wc"],
                     t_wc=f["t_wc"])


def _tris(mesher):
    return {c: {tuple(sorted(t)) for t in v.tolist()}
            for c, v in mesher.tris.items()}


def test_online_mesher_matches_jax(sign_convention, drive, tmp_path):
    """Both meshers over the drive, draining every second frame: the same
    store, triangle registry and stats; export_ply's header counts equal
    stats() and every face indexes a live vertex."""
    jme = jim.OnlineMesher(MESHER_CFG, intrinsics=DRIVE_INTR, drain_every=2)
    tme = tim.OnlineMesher(_tcfg(MESHER_CFG), intrinsics=DRIVE_INTR,
                           drain_every=2, device="cpu")
    for f in drive:
        _feed(jme, f)
        _feed(tme, f)
    _assert_store_equal(tme.mesh, jme.mesh, rgb_tol=1e-3)
    assert _tris(tme) == _tris(jme)
    st = tme.stats()
    assert st == jme.stats()
    assert st["triangles"] > 200 and st["vertices"] > 1000
    textured = (tme.mesh.w > 0) & (tme.mesh.code != INVALID)
    assert int(textured.sum()) > 100
    nv, nf = tme.export_ply(str(tmp_path / "mesh.ply"))
    lines = (tmp_path / "mesh.ply").read_text().splitlines()
    head = lines[:lines.index("end_header")]
    assert f"element vertex {st['vertices']}" in head
    assert f"element face {st['triangles']}" in head
    assert (nv, nf) == (st["vertices"], st["triangles"])
    faces = np.array([l.split() for l in lines[len(head) + 1 + nv:]], int)
    assert faces.shape == (nf, 4) and (faces[:, 0] == 3).all()
    assert faces[:, 1:].min() >= 0 and faces[:, 1:].max() < nv


def test_mesher_from_jax(sign_convention, drive):
    """A JAX mesher after one frame, carried over (store, registry, dirty
    set, counters); one more frame into both: the stores and registries are
    equal."""
    jme = jim.OnlineMesher(MESHER_CFG, intrinsics=DRIVE_INTR, drain_every=2)
    _feed(jme, drive[0])
    assert jme._pending                      # frame 1 is not drained yet
    tme = convert.mesher_from_jax(jme, "cpu")
    assert tme._pending == jme._pending and tme.frames == 1
    for m in (jme, tme):
        _feed(m, drive[1])
    _assert_store_equal(tme.mesh, jme.mesh, rgb_tol=1e-3)
    assert _tris(tme) == _tris(jme) and tme.stats() == jme.stats()


def test_retriangulate_plain_any_batch():
    """retriangulate_plain over B = 3·dirty_batch + 5 voxels (INVALID
    padding among them) equals its calls on each dirty_batch chunk,
    concatenated; the packed form holds each voxel's kept slots at its
    offset, in voxel order."""
    cfg = tim.MeshConfig(capacity=4096, insert_chunk=1024, cand=12,
                         dirty_batch=4)
    cloud = torch.as_tensor(checks.mesh_room_cloud(2048, seed=5))
    mesh = tim.MeshMap.empty(cfg, device="cpu")
    for k in range(2):
        mesh, _ = tim.insert(mesh, cloud[k * 1024:(k + 1) * 1024],
                             torch.ones(1024), cfg)
    live = torch.unique(mesh.code[mesh.code != INVALID])
    B = 3 * cfg.dirty_batch + 5
    codes = live[torch.randperm(live.numel(), generator=torch.Generator()
                                .manual_seed(1))[:B]].to(torch.int32)
    codes[[2, 9]] = INVALID
    tv, tm, keep = tim.retriangulate_plain(mesh, codes, cfg, with_keep=True)
    parts = [tim.retriangulate_plain(mesh, codes[s:s + cfg.dirty_batch], cfg,
                                     with_keep=True)
             for s in range(0, B, cfg.dirty_batch)]
    assert tv.shape[0] == B and len(parts) == 5
    for got, want in zip((tv, tm, keep), zip(*parts)):
        assert torch.equal(got, torch.cat(want))
    assert int(tm.sum()) > 10 and not tm[[2, 9]].any()
    meta, packed = tim.retriangulate_packed(mesh, codes, cfg)
    cnt, off = meta[:B], meta[B:2 * B]
    assert torch.equal(cnt, tm.sum(1, dtype=torch.int32))
    assert int(meta[-1]) == int(tm.sum())
    for b in range(B):
        n, o = int(cnt[b]), int(off[b])
        assert torch.equal(packed[o:o + n], tv[b, :n])


def _batch_drain(mesher):
    """The drain as the JAX package runs it: ``dirty_batch`` voxels a call
    in the order the set pops them, each batch read back and booked."""
    cfg = mesher.cfg
    while mesher._pending:
        batch = [mesher._pending.pop()
                 for _ in range(min(cfg.dirty_batch, len(mesher._pending)))]
        codes = np.full(cfg.dirty_batch, INVALID, np.int32)
        codes[:len(batch)] = batch
        tv, tm = (x.numpy() for x in tim.retriangulate(
            mesher.mesh, torch.as_tensor(codes), cfg))
        for i, c in enumerate(batch):
            tris = tv[i][tm[i]]
            if tris.size:
                mesher.tris[c] = tris
            else:
                mesher.tris.pop(c, None)


def test_one_call_drain_equals_batch_drain(drive):
    """Two meshers fed the same frames (so their dirty sets pop in the same
    order): the one-call drain and the batch-by-batch drain leave the same
    registry, voxel by voxel and in insertion order, after each of two
    drains (the second re-meshes voxels of the first)."""
    cfg = _tcfg(MESHER_CFG)._replace(dirty_batch=8, cand=10)
    one, ref = (tim.OnlineMesher(cfg, intrinsics=DRIVE_INTR, drain_every=99,
                                 device="cpu") for _ in range(2))
    for f in drive[:2]:
        for m in (one, ref):
            _feed(m, f)
        assert one._pending == ref._pending and len(one._pending) > 8
        one._drain()
        _batch_drain(ref)
        assert not one._pending
        assert list(one.tris) == list(ref.tris)
        for c, t in ref.tris.items():
            np.testing.assert_array_equal(one.tris[c], t)
    assert sum(len(t) for t in one.tris.values()) > 100
    np.testing.assert_array_equal(one.triangles(), ref.triangles())


def test_voxel_export_matches_jax(rng, tmp_path):
    """mesh/export.py on test_voxel_mesh_export's floor map carried into the
    port: the same vertices and faces, the same PLY text."""
    cfg = jvm.VoxelMapConfig(capacity=1 << 12)
    xy = rng.uniform(-2, 2, size=(2000, 2))
    pts = jnp.asarray(np.column_stack([xy, np.zeros(2000)]), jnp.float32)
    jmap = jvm.insert(jvm.VoxelMap.empty(cfg), pts, jnp.ones((2000,)), cfg)
    tmap = convert.to_torch(jmap, "cpu")
    assert isinstance(tmap, tvm.VoxelMap)
    tv, tf = texport.voxel_surface_mesh(tmap, cfg)
    jv, jf = jexport.voxel_surface_mesh(jmap, cfg)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    assert tf.shape[0] > 100
    for name, j, t in (("mesh", jexport.export_voxel_mesh_ply,
                        texport.export_voxel_mesh_ply),):
        assert t(str(tmp_path / f"t_{name}.ply"), tmap, cfg) == \
            j(str(tmp_path / f"j_{name}.ply"), jmap, cfg)
        assert (tmp_path / f"t_{name}.ply").read_text() == \
            (tmp_path / f"j_{name}.ply").read_text()
    cols = rng.uniform(0, 255, (100, 3))
    jexport.export_pointcloud_ply(str(tmp_path / "j.ply"),
                                  np.asarray(jmap.pts[:100]), cols)
    texport.export_pointcloud_ply(str(tmp_path / "t.ply"), tmap.pts[:100],
                                  cols)
    assert (tmp_path / "t.ply").read_text() == (tmp_path / "j.ply").read_text()


def test_mesh_checks_run_on_the_cpu():
    """checks.check_mesh_* (chip_smoke.py's phase 14) on the CPU, where
    kernel and plain version are the same code: every comparison holds."""
    cfg = tim.MeshConfig(capacity=4096, insert_chunk=1024)
    cloud = torch.as_tensor(checks.mesh_room_cloud(2048, seed=3))
    ones = torch.ones(1024)
    mesh, _ = tim.insert(tim.MeshMap.empty(cfg, device="cpu"), cloud[:1024],
                         ones, cfg)
    r = checks.check_mesh_insert("cpu", mesh, cloud[1024:], ones, cfg,
                                 timed=False)
    assert r["ok"] and r["max_abs_err"] == 0.0, r
    img = torch.full((120, 160, 3), 99.0)
    down = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)
    r = checks.check_mesh_rgb("cpu", mesh, img, DRIVE_INTR, down,
                              np.array([0.0, 0.0, 3.0], np.float32), cfg,
                              timed=False)
    assert r["ok"] and r["visible"] > 10, r
    codes = torch.unique(mesh.code[mesh.code != INVALID])[:cfg.dirty_batch]
    r = checks.check_mesh_delaunay("cpu", mesh, codes.to(torch.int32), cfg,
                                   timed=False)
    assert r["ok"] and r["differing_triples"] == 0 and r["triangles"] > 0, r
    # the margins a differing triple would be named with: a kept triangle
    # passes each test by more than the band
    sel, vid, mask = tim.gather_candidates(mesh, codes.to(torch.int32), cfg)
    tv, tk, keep = tim.retriangulate(mesh, codes.to(torch.int32), cfg,
                                     with_keep=True)
    b, t = (int(x) for x in keep.nonzero()[0])
    mg = checks._triple_margins(tim.plane_coords(sel, vid, mask, cfg)[b],
                                sel[b], mask[b], mesh.origin, cfg, t)
    assert min(mg["sliver"], mg["edge"], mg["incircle"]) > checks.DELAUNAY_BAND
