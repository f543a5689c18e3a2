"""Kernels L and P's host side on the CPU: the closure that packs a solve's
inputs once, and the per-layout tables the reduce walks.

``small_normal_fn``'s closure against the one-shot ``small_normal_equations``
on the example window (F = 8) with every factor family on and off; the CSR
lists of each frame row's instances against a numpy model of the kernel's
``dense_col``; the reduce's walk over those lists against the walk over
every instance, bit for bit on random partials; and the rows the plain
route's H couples against the lists. The card's side (the kernels against
the plain route, the same bits twice, launches a call) is in
``tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from ground_fusion2_tpu_torch import checks
from ground_fusion2_tpu_torch.config import VioConfig
from ground_fusion2_tpu_torch.factors import vio_factors as fac
from ground_fusion2_tpu_torch.vio.state import WindowLayout

torch.set_num_threads(1)
F = 8
S = 16


@pytest.fixture(scope="module")
def window():
    x0, feats, layout, delta = checks.example_window(F, "cpu")
    meas = checks.example_measurements(x0, feats, layout, "cpu")
    xg, mg = checks.example_gnss(x0, meas, layout, "cpu")
    return x0, meas, xg, mg, layout, delta


def _cfg(on: bool, gnss: bool) -> VioConfig:
    return VioConfig(num_feats=F, use_wheel=on, use_plane=on, use_motion=on,
                     use_gnss=gnss)


@pytest.mark.parametrize("on", [True, False], ids=["all_on", "all_off"])
def test_small_normal_fn_equals_one_shot(window, on):
    """The closure at three deltas (zero, the example's, a larger step) gives
    the one-shot's H, g and cost bit for bit, with GNSS, wheel, plane and
    motion all on (P's instances included) and all off."""
    x0, meas, xg, mg, layout, delta = window
    x, m = (xg, mg) if on else (x0, meas)
    cfg = _cfg(on, on)
    fn = fac.small_normal_fn(x, m, layout, cfg)
    for d in (torch.zeros_like(delta), delta, 3.0 * delta):
        got = fn(d)
        want = fac.small_normal_equations(x, d, m, layout, cfg)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert torch.isfinite(got[0]).all() and float(got[2]) > 0


def _model_touch(layout: WindowLayout, S: int, cfg) -> np.ndarray:
    """[n_inst, fd] bool: which frame columns each instance touches, lane by
    lane as each family's residual seeds its duals (``dense_col`` below, a
    switch over the families as csrc/window_rows.cuh's ``residual`` orders
    their tangents), in the instance order of its ``instance``."""
    L = layout
    po, so, we = L.pose_off, L.sb_off, L.wext_off

    def dense_col(kind, k, l):
        if kind == "imu":
            return (po + 6 * k + l if l < 6 else so + 9 * k + l - 6 if l < 15
                    else po + 6 * (k + 1) + l - 15 if l < 21
                    else so + 9 * (k + 1) + l - 21 if l < 30 else -1)
        if kind == "wheel":
            return (po + 6 * k + l if l < 6 else po + 6 * (k + 1) + l - 6
                    if l < 12 else we + l - 12 if l < 18
                    else L.wint_off + l - 18 if l < 21 else -1)
        if kind == "plane":
            return (po + l if l < 6 else po + 6 * k + l - 6 if l < 12
                    else we + l - 12 if l < 18 else -1)
        if kind == "motion":
            return (po + 6 * k + l if l < 6 else so + 9 * k + l - 6 if l < 9
                    else we + l - 9 if l < 15 else -1)
        if kind == "posvel":
            return (po + 6 * k + l if l < 3 else po + 6 * (k + 1) + l - 3
                    if l < 6 else so + 9 * k + l - 6 if l < 9
                    else so + 9 * (k + 1) + l - 9 if l < 12 else -1)
        if kind == "gnss_psr":
            w = k // S
            return (po + 6 * w + l if l < 3 else L.gyaw_off if l == 3
                    else L.ganchor_off + l - 4 if l < 7
                    else L.gdt_off + 4 * w + l - 7 if l < 11 else -1)
        if kind == "gnss_dopp":
            w = k // S
            return (so + 9 * w + l if l < 3 else L.gyaw_off if l == 3
                    else L.gddt_off + w if l == 4 else -1)
        return (L.gdt_off + 4 * k + l if l < 8 else L.gddt_off + k + l - 8
                if l < 10 else -1)

    rows = []
    for kind, n in fac._instance_counts(L.W, S, cfg).items():
        for k in range(n):
            kk = k + 1 if kind == "plane" else k
            touch = np.zeros(L.frame_dim, bool)
            for l in range(32):
                c = dense_col(kind, kk, l)
                if c >= 0:
                    touch[c] = True
            rows.append(touch)
    return np.stack(rows)


@pytest.mark.parametrize("gnss", [True, False], ids=["gnss", "no_gnss"])
def test_row_lists_match_dense_col_model(gnss):
    """At W = 11 (S = 16 with GNSS): each frame row's CSR list is the
    instances whose model columns include it, in increasing order, with the
    instance's lane of that column."""
    layout = WindowLayout(F)
    assert layout.W == 11
    cfg = _cfg(True, gnss)
    touch = _model_touch(layout, S, cfg)
    tab = fac.small_layout(layout, S, cfg, "cpu")
    lcol = tab.lcol.numpy()
    assert lcol.shape == (fac._n_instances(layout.W, S, cfg), 32)
    assert touch.shape[0] == lcol.shape[0]
    rowptr, rinst, rlane = (t.numpy() for t in (tab.rowptr, tab.rinst,
                                                tab.rlane))
    assert rowptr[0] == 0 and rowptr[-1] == touch.sum()
    for r in range(layout.frame_dim):
        seg = slice(rowptr[r], rowptr[r + 1])
        np.testing.assert_array_equal(rinst[seg], np.nonzero(touch[:, r])[0])
        np.testing.assert_array_equal(lcol[rinst[seg], rlane[seg]], r)
    covered = np.zeros_like(touch)
    n_idx, lane = np.nonzero(lcol >= 0)
    covered[n_idx, lcol[n_idx, lane]] = True
    np.testing.assert_array_equal(covered, touch)
    # the longest list: every pseudorange and Doppler row touches the yaw
    longest = int(np.diff(rowptr).max())
    assert longest == (2 * layout.W * S if gnss else layout.W - 1 + layout.W
                       + layout.W - 1), longest


def _parent_walk(part_H, part_g, lcol, fd):
    """The parent reduce's sums in float32: entry (r, c) over every
    instance in index order, adding where the instance has a lane on r and
    one on c (its ``inv`` table)."""
    n_inst = lcol.shape[0]
    inv = np.full((n_inst, fd), -1)
    n_idx, lane = np.nonzero(lcol >= 0)
    inv[n_idx, lcol[n_idx, lane]] = lane
    H = np.zeros((fd, fd), np.float32)
    g = np.zeros(fd, np.float32)
    for r in range(fd):
        for n in range(n_inst):
            lr = inv[n, r]
            if lr < 0:
                continue
            g[r] = np.float32(g[r] + part_g[n, lr])
            cols = np.nonzero(inv[n] >= 0)[0]
            H[r, cols] = (H[r, cols] + part_H[n, lr, inv[n, cols]]).astype(
                np.float32)
    return H, g


def _row_walk(part_H, part_g, lcol, tab, fd):
    """The kernel's sums in float32: row r walks its CSR list; instance n
    adds the partial of each lane l to column lcol[n, l]."""
    rowptr, rinst, rlane = tab
    H = np.zeros((fd, fd), np.float32)
    g = np.zeros(fd, np.float32)
    for r in range(fd):
        for p in range(rowptr[r], rowptr[r + 1]):
            n, lr = rinst[p], rlane[p]
            g[r] = np.float32(g[r] + part_g[n, lr])
            lanes = np.nonzero(lcol[n] >= 0)[0]
            cols = lcol[n, lanes]
            H[r, cols] = (H[r, cols] + part_H[n, lr, lanes]).astype(np.float32)
    return H, g


def test_reduce_over_row_lists_equals_full_walk():
    """The kernel's walk over each row's CSR list, scattering an instance's
    lanes to their columns, adds what the parent kernel's walk over every
    instance added, in the same order: H and g equal bit for bit on random
    float32 partials (GNSS on, 418 instances)."""
    layout = WindowLayout(F)
    cfg = _cfg(True, True)
    tab = fac.small_layout(layout, S, cfg, "cpu")
    lcol = tab.lcol.numpy()
    fd = layout.frame_dim
    rng = np.random.default_rng(4)
    n_inst = lcol.shape[0]
    part_H = rng.normal(size=(n_inst, 32, 32)).astype(np.float32)
    part_g = rng.normal(size=(n_inst, 32)).astype(np.float32)
    H0, g0 = _parent_walk(part_H, part_g, lcol, fd)
    H1, g1 = _row_walk(part_H, part_g, lcol, [t.numpy() for t in (
        tab.rowptr, tab.rinst, tab.rlane)], fd)
    np.testing.assert_array_equal(H1, H0)
    np.testing.assert_array_equal(g1, g0)
    assert np.count_nonzero(H0) > 5000


def test_plain_couplings_within_row_lists(window):
    """Every frame entry the plain route's H couples (the prior off, every
    family on, GNSS gate on) lies on two columns that one instance touches:
    the lists miss no coupling the rows have."""
    x0, meas, xg, mg, layout, delta = window
    cfg = _cfg(True, True)
    m = mg._replace(prior=mg.prior._replace(
        valid=torch.zeros_like(mg.prior.valid)))
    H, _, _ = fac.small_normal_equations(xg, delta, m, layout, cfg)
    K = layout.frame_dim
    lcol = fac.small_layout(layout, S, cfg, "cpu").lcol.numpy()
    couple = np.zeros((K, K), bool)
    for cols in lcol:
        c = cols[cols >= 0]
        couple[np.ix_(c, c)] = True
    nz = H[:K, :K].numpy() != 0
    assert nz.sum() > 1000
    assert not (nz & ~couple).any()
