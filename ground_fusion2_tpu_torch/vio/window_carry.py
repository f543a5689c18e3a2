"""The camera tick's carry bookkeeping: kernel AI (``csrc/window_carry.cu``),
port of ``ground_fusion2_tpu/vio/fused.py:297 _solve_tick``'s writes (step 1
/ 1b, the biases at the new column), its slide's ``lax.switch`` with
``_merge_last_two``, and the record.

:func:`write` puts this tick's IMU interval, time and GNSS epoch into the
window; :func:`slide` shifts (MARGIN_OLD) or merges (MARGIN_SECOND_NEW)
every interval buffer, the valid flags, the times, the GNSS table and the
frame states, and writes the tick's [23] record. Both take ``col``, ``t``
and ``full`` from the tick's unpacked inputs (device scalars) and the slide
its branch from ``full`` and ``is_kf`` on the device. On the card each is
one launch writing fresh outputs; on the CPU the plain PyTorch route.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _kernels
from ..gnss.factors import GnssTable, unpack_gnss_row

INTERVAL = ("acc", "gyr", "wvel", "dt", "smask")
STATE = ("p", "q", "v", "ba", "bg", "gdt", "gddt")
RECORD_LEN = 23

# csrc/window_carry.cu's segment kinds
W_COPY, W_SRC_K, W_SRC_COL, W_VAL_K, W_SELF_COL_FROM_K = range(5)
S_ROLL_ZERO, S_REPEAT, S_SAMPLES, S_DT, S_MASK, S_MAX, S_MIN = range(7)


def _p(t):
    return None if t is None else t.data_ptr()


def _arr(ctype, vals):
    return (ctype * len(vals))(*vals)


def _f32c(t, name):
    if not t.is_cuda or t.dtype != torch.float32:
        raise ValueError(f"kernel AI takes float32 CUDA tensors ({name}: "
                         f"{t.dtype} on {t.device})")
    return t.contiguous()


def _bool(t):
    return t if t.dtype == torch.bool else t > 0.5


# ----------------------------------------------------------------- write
def write_plain(c, inp, use_wheel: bool):
    col = int(inp.col)
    k = col - 1

    def put(buf, i, val):
        buf = buf.clone()
        buf[i] = val
        return buf

    row = unpack_gnss_row(inp.gnss_row)
    g = c.gnss._replace(**{f: put(getattr(c.gnss, f), col, row[f])
                           for f in GnssTable.ROW_FIELDS})
    st = c.state
    return c._replace(
        acc=put(c.acc, k, inp.acc), gyr=put(c.gyr, k, inp.gyr),
        wvel=put(c.wvel, k, inp.wvel), dt=put(c.dt, k, inp.dt),
        smask=put(c.smask, k, inp.smask),
        imu_valid=put(c.imu_valid, k, 1.0),
        wheel_valid=put(c.wheel_valid, k, 1.0 if use_wheel else 0.0),
        times=put(c.times, col, inp.t), gnss=g,
        state=st._replace(ba=put(st.ba, col, st.ba[k]),
                          bg=put(st.bg, col, st.bg[k])))


def write(c, inp, use_wheel: bool):
    """The carry with this tick's interval at k = col − 1 (its samples, the
    IMU and wheel flags), ``times[col] = t``, the GNSS epoch ``gnss_row``
    at col and ``ba``/``bg`` at col from k: kernel AI's write mode on the
    card, :func:`write_plain` on the CPU."""
    if not c.acc.is_cuda:
        return write_plain(c, inp, use_wheel)
    row = unpack_gnss_row(inp.gnss_row)
    st = c.state
    segs = [(c.acc, inp.acc, W_SRC_K), (c.gyr, inp.gyr, W_SRC_K),
            (c.wvel, inp.wvel, W_SRC_K), (c.dt, inp.dt, W_SRC_K),
            (c.smask, inp.smask, W_SRC_K), (c.imu_valid, None, W_VAL_K),
            (c.wheel_valid, None, W_VAL_K), (c.times, inp.t, W_SRC_COL)]
    segs += [(getattr(c.gnss, f), row[f], W_SRC_COL)
             for f in GnssTable.ROW_FIELDS]
    segs += [(st.ba, None, W_SELF_COL_FROM_K), (st.bg, None, W_SELF_COL_FROM_K)]
    ins = [_f32c(b, "carry") for b, _, _ in segs]
    outs = [torch.empty_like(b) for b in ins]
    values = [0.0] * len(segs)
    values[5], values[6] = 1.0, 1.0 if use_wheel else 0.0
    n = len(segs)
    keep = [_arr(ctypes.c_void_p, [_p(b) for b in ins]),
            _arr(ctypes.c_void_p, [_p(o) for o in outs]),
            _arr(ctypes.c_void_p, [_p(s) for _, s, _ in segs]),
            _arr(ctypes.c_int, [b.shape[0] for b in ins]),
            _arr(ctypes.c_int, [b.numel() // b.shape[0] for b in ins]),
            _arr(ctypes.c_int, [k for _, _, k in segs]),
            _arr(ctypes.c_float, values)]
    dev = c.acc.device
    err = _kernels.library().gf2_carry_write(
        n, *(ctypes.cast(a, ctypes.c_void_p) for a in keep),
        ctypes.c_void_p(_f32c(inp.col, "col").data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _kernels.check(err, "gf2_carry_write")
    _kernels.count("window_carry")
    o = dict(zip(INTERVAL + ("imu_valid", "wheel_valid", "times"), outs[:8]))
    g = c.gnss._replace(**dict(zip(GnssTable.ROW_FIELDS, outs[8:15])))
    return c._replace(**o, gnss=g,
                      state=st._replace(ba=outs[15], bg=outs[16]))


# ----------------------------------------------------------------- slide
def _roll_left(b):
    return torch.cat([b[1:], torch.zeros_like(b[:1])])


def _move_last(b):
    b = b.clone()
    b[-2] = b[-1]
    b[-1] = 0
    return b


def merge_last_two(acc, gyr, wvel, dt, sm):
    """SECOND_NEW buffers: concat the last two intervals into slot [-2],
    dropping the oldest samples on overflow; the counts n0, n1 are the
    last two rows' sums of ``sm``, as JAX derives them (device integers:
    nothing is read on the host)."""
    M = dt.shape[1]
    n0 = sm[-2].sum().to(torch.int64)
    n1 = sm[-1].sum().to(torch.int64)
    total = n0 + n1
    ofs = torch.clamp(total - M, min=0)
    dev = dt.device
    k = torch.arange(M + 1, device=dev) + ofs
    from0 = k <= n0
    i0 = torch.clamp(k, 0, M)
    i1 = torch.clamp(k - n0, 0, M)

    def samp(b):
        b = b.clone()
        b[-2] = torch.where(from0[:, None], b[-2][i0], b[-1][i1])
        b[-1] = 0.0
        return b

    kd = torch.arange(M, device=dev) + ofs
    id0 = torch.clamp(kd, 0, M - 1)
    id1 = torch.clamp(kd - n0, 0, M - 1)
    m_m = (kd < total).to(sm.dtype)
    dt_new = dt.clone()
    dt_new[-2] = torch.where(kd < n0, dt[-2][id0], dt[-1][id1]) * m_m
    dt_new[-1] = 0.0
    sm_new = sm.clone()
    sm_new[-2] = m_m
    sm_new[-1] = 0.0
    return samp(acc), samp(gyr), samp(wvel), dt_new, sm_new


def _record_plain(st, col: int, cost, is_kf, stationary, anomaly,
                  track_valid, alive, par):
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                    device=st.p.device).reshape(1)
    return torch.cat([
        st.p[col], st.q[col], st.v[col],
        f32(cost), f32(is_kf), f32(stationary), f32(anomaly),
        f32(track_valid.sum()), f32(alive.sum()), f32(par),
        st.ba[col], st.bg[col]])


def _fields(c):
    """The slid buffers of the carry, in a fixed order."""
    g, st = c.gnss, c.state
    return ([c.acc, c.gyr, c.wvel, c.dt, c.smask, c.imu_valid,
             c.wheel_valid, c.times]
            + [getattr(g, f) for f in GnssTable.ROW_FIELDS]
            + [getattr(st, f) for f in STATE])


def _with_fields(c, vals):
    g = c.gnss._replace(**dict(zip(GnssTable.ROW_FIELDS, vals[8:15])))
    st = c.state._replace(**dict(zip(STATE, vals[15:])))
    return c._replace(**dict(zip(INTERVAL + ("imu_valid", "wheel_valid",
                                             "times"), vals[:8])),
                      gnss=g, state=st)


def slide_plain(c, inp, is_kf, cost, stationary, anomaly, alive, par):
    """Both slides and a select by ``full`` and ``is_kf`` (no host read of
    either; a select copies, so an unselected branch never mixes in)."""
    col = int(inp.col)
    rec = _record_plain(c.state, col, cost, is_kf, stationary, anomaly,
                        c.fw.track_valid, alive, par)
    st, g = c.state, c.gnss
    sh = lambda a: torch.cat([a[1:], a[-1:]], 0)
    old = _fields(c._replace(
        acc=_roll_left(c.acc), gyr=_roll_left(c.gyr),
        wvel=_roll_left(c.wvel), dt=_roll_left(c.dt),
        smask=_roll_left(c.smask), imu_valid=_roll_left(c.imu_valid),
        wheel_valid=_roll_left(c.wheel_valid), times=sh(c.times),
        gnss=g._replace(**{f: _roll_left(getattr(g, f))
                           for f in GnssTable.ROW_FIELDS}),
        state=st._replace(**{f: sh(getattr(st, f)) for f in STATE})))
    acc, gyr, wvel, dt, sm = merge_last_two(c.acc, c.gyr, c.wvel, c.dt,
                                            c.smask)
    iv, wv = c.imu_valid.clone(), c.wheel_valid.clone()
    iv[-2] = torch.maximum(iv[-2], iv[-1])
    iv[-1] = 0.0
    wv[-2] = torch.minimum(wv[-2], wv[-1])
    wv[-1] = 0.0

    def mv(a):
        a = a.clone()
        a[-2] = a[-1]
        return a
    second = _fields(c._replace(
        acc=acc, gyr=gyr, wvel=wvel, dt=dt, smask=sm, imu_valid=iv,
        wheel_valid=wv, times=mv(c.times),
        gnss=g._replace(**{f: _move_last(getattr(g, f))
                           for f in GnssTable.ROW_FIELDS}),
        state=st._replace(**{f: mv(getattr(st, f)) for f in STATE})))
    full, kf = inp.full > 0.5, _bool(is_kf)
    vals = [torch.where(full, torch.where(kf, a, b), n)
            for a, b, n in zip(old, second, _fields(c))]
    return _with_fields(c, vals), rec


def slide(c, inp, is_kf, cost, stationary, anomaly, alive, par):
    """The slide of every interval buffer, the valid flags, ``times``, the
    GNSS table and the frame states (p, q, v, ba, bg, gdt, gddt), in the
    branch ``full`` and ``is_kf`` pick (none, MARGIN_OLD, MARGIN_SECOND_NEW),
    and the tick's record [23] from the solved state at col, the LM's
    ``cost``, the flags, the window's ``track_valid`` (``c.fw``: the slid
    window) and the frame's ``alive``, and ``par``. Returns (carry, record).
    Kernel AI's slide mode on the card (its branch read on the device),
    :func:`slide_plain` on the CPU."""
    if not c.acc.is_cuda:
        return slide_plain(c, inp, is_kf, cost, stationary, anomaly, alive,
                           par)
    st, g = c.state, c.gnss
    segs = [(c.acc, S_SAMPLES), (c.gyr, S_SAMPLES), (c.wvel, S_SAMPLES),
            (c.dt, S_DT), (c.smask, S_MASK), (c.imu_valid, S_MAX),
            (c.wheel_valid, S_MIN), (c.times, S_REPEAT)]
    segs += [(getattr(g, f), S_ROLL_ZERO) for f in GnssTable.ROW_FIELDS]
    segs += [(getattr(st, f), S_REPEAT) for f in STATE]
    ins = [_f32c(b, "carry") for b, _ in segs]
    outs = [torch.empty_like(b) for b in ins]
    dev = c.acc.device
    f32 = lambda t, n: _f32c(t.to(torch.float32).reshape(()).contiguous(), n)
    b8 = lambda t: _bool(t).reshape(()).contiguous()
    rec_in = [_f32c(getattr(st, f), f) for f in STATE[:5]] + [
              f32(cost, "cost"),
              f32(par, "par"), b8(is_kf), b8(stationary), b8(anomaly),
              _f32c(c.fw.track_valid.contiguous(), "track_valid"),
              _f32c(alive.contiguous(), "alive")]
    rec = torch.empty((RECORD_LEN,), dtype=torch.float32, device=dev)
    keep = [_arr(ctypes.c_void_p, [_p(b) for b in ins]),
            _arr(ctypes.c_void_p, [_p(o) for o in outs]),
            _arr(ctypes.c_int, [b.shape[0] for b in ins]),
            _arr(ctypes.c_int, [b.numel() // b.shape[0] for b in ins]),
            _arr(ctypes.c_int, [k for _, k in segs])]
    ptrs = _arr(ctypes.c_void_p, [_p(t) for t in rec_in])
    err = _kernels.library().gf2_carry_slide(
        len(segs), *(ctypes.cast(a, ctypes.c_void_p) for a in keep),
        ctypes.c_void_p(_f32c(inp.full, "full").data_ptr()),
        ctypes.c_void_p(rec_in[7].data_ptr()),
        ctypes.c_void_p(ins[4].data_ptr()), c.dt.shape[1],
        ctypes.c_void_p(_f32c(inp.col, "col").data_ptr()),
        ctypes.cast(ptrs, ctypes.c_void_p), alive.shape[0],
        ctypes.c_void_p(rec.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _kernels.check(err, "gf2_carry_slide")
    _kernels.count("window_carry")
    o = dict(zip(INTERVAL + ("imu_valid", "wheel_valid", "times"), outs[:8]))
    g = g._replace(**dict(zip(GnssTable.ROW_FIELDS, outs[8:15])))
    st = st._replace(**dict(zip(STATE, outs[15:22])))
    return c._replace(**o, gnss=g, state=st), rec
