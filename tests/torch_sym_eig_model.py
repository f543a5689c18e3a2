"""A numpy model of kernel X's symmetric eigensolver
(``ground_fusion2_tpu_torch/csrc/sym_eig.cu``), in float64, used only by
``tests/test_torch_sym_eig_model.py``: the algorithm is debugged here on
the CPU, step for step as the kernel runs it.

1. Householder tridiagonalization, column by column: v = x − α e₁ with
   α = −sign(x₀)‖x‖, β = 2/vᵀv = 1/(α² − x₀α), p = β A₂₂ v,
   w = p − ½β(pᵀv) v, A₂₂ −= v wᵀ + w vᵀ; T's subdiagonal is α (no
   reflector where ‖x‖² ≤ TINY_SQ or x is already e₁-aligned).
2. Cuppen's divide-and-conquer on T (LAPACK dstedc / dlaed0–dlaed4), with
   the tridiagonal scaled by its largest entry:
   * every subdiagonal entry is torn (leaves of size ``LEAF`` = 1: each
     leaf is its own eigenvalue, eigenvector [1]);
   * merges bottom-up, blocks of 2^l into 2^(l+1); a merge at split s
     takes ρ = 2|e_{s−1}| and z = [last row of Q₁, sign(e_{s−1})·first row
     of Q₂]/√2, sorts the poles (ties: the left child first), deflates
     as dlaed2 does (ρ|z_j| ≤ tol, then close pairs |t·c·s| ≤ tol by a
     Givens rotation of two columns; tol = 8 eps max(max|d|, max|z|));
   * each secular root by its own iteration (dlaed4's bracket, its
     two-pole rational model: the pole at the origin with its own weight,
     the other pole's weight and a constant fitted to f and f', written
     without the near pole's terms so that nothing cancels, and dlaed4's
     quadratic; Newton where the model steps the wrong way, halfway to the bracket's
     end where it leaves it; converged at |f| ≤ eps·(8Σ|terms| + 2/ρ +
     3|τ|f')), at most ``max_iters`` steps, else the solve fails;
   * Gu–Eisenstat's recomputed ẑ, u_ij = ẑ_i/(d_i − λ_j) normalized, the
     merged columns Q[:, kept]·U and the deflated columns as they are, all
     sorted ascending (ties: roots before deflated values, each in order).
3. V = H₀ H₁ ··· H_{n−3} Z, the reflectors applied to Z from the last.

A failed solve (a root past its cap, or a non-finite tridiagonal) gives
all-NaN w and V, as the kernel does.
"""

from __future__ import annotations

import numpy as np

LEAF = 1
MAX_ITERS = 30
EPS64 = 2.0 ** -53
# a column whose squared norm is below this is taken as reduced (its
# entries, < 1e-140, beside the scaled matrix's O(1)): 1/(α² − x₀α) would
# overflow
TINY_SQ = 1e-280


def tridiagonalize(A: np.ndarray):
    """(d, e, R, beta): T = tridiag(e, d, e) with e[k] = T[k+1, k]; row k of
    R holds reflector k's v in columns k+1.., beta[k] its 2/vᵀv."""
    A = np.tril(A) + np.tril(A, -1).T
    A = A.astype(np.float64).copy()
    n = A.shape[0]
    d, e, beta = np.zeros(n), np.zeros(n), np.zeros(n)
    R = np.zeros((n, n))
    for k in range(n - 2):
        x = A[k + 1:, k].copy()
        sigma = float(x @ x)
        x0 = x[0]
        if sigma > TINY_SQ and sigma - x0 * x0 > 0:
            alpha = -np.sqrt(sigma) if x0 >= 0 else np.sqrt(sigma)
            v = x.copy()
            v[0] = x0 - alpha
            b = 1.0 / (alpha * alpha - x0 * alpha)
        else:
            alpha, v, b = x0, np.zeros_like(x), 0.0
        d[k], e[k], beta[k] = A[k, k], alpha, b
        R[k, k + 1:] = v
        if b != 0:
            A22 = A[k + 1:, k + 1:]
            p = b * (A22 @ v)
            w = p - 0.5 * b * float(p @ v) * v
            A22 -= np.outer(v, w) + np.outer(w, v)
    if n >= 2:
        d[n - 2], e[n - 2] = A[n - 2, n - 2], A[n - 1, n - 2]
    d[n - 1] = A[n - 1, n - 1]
    return d, e, R, beta


def _evaluate(tau, dorg, w2, rho, org):
    """The secular function's pieces at τ for each root (vectorized over
    roots: rows), δ_j = dorg_j − τ: f/ρ = 1/ρ + Σ w_j²/δ_j split into the
    pole at the origin (t_n, its derivative dt_n) and the rest (w_rest,
    dw_rest), so that no step subtracts the near pole's huge terms; the
    error bound 8Σ|terms| + 2/ρ + 3|τ|f'."""
    delta = dorg - tau[:, None]
    t = w2[None, :] / delta
    dt = t / delta
    near = np.arange(dorg.shape[1])[None, :] == org[:, None]
    w_rest = 1.0 / rho + np.where(near, 0.0, t).sum(1)
    dw_rest = np.where(near, 0.0, dt).sum(1)
    t_n = np.where(near, t, 0.0).sum(1)
    dt_n = np.where(near, dt, 0.0).sum(1)
    wv = w_rest + t_n
    dw = dw_rest + dt_n
    err = 8.0 * np.abs(t).sum(1) + 2.0 / rho + 3.0 * np.abs(tau) * dw
    return delta, wv, w_rest, dw_rest, dw, err


def secular_roots(dl, w, rho, max_iters, eps):
    """The K roots of 1 + ρ Σ w_j²/(dl_j − λ) = 0 (dl strictly ascending,
    ρ > 0): (origin index, τ, δ [K poles, K roots], ok) with
    λ_j = dl[org_j] + τ_j and δ[i, j] = (dl_i − dl[org_j]) − τ_j."""
    K = len(dl)
    w2 = w * w
    if K == 1:
        tau = np.array([rho * w2[0]])
        return np.zeros(1, int), tau, -tau[None, :], True
    roots = np.arange(K)
    last = roots == K - 1
    # interior roots: f at the midpoint picks the origin and the bracket
    nxt = np.minimum(roots + 1, K - 1)
    mid = np.where(last, 1.0, 0.5 * (dl[nxt] - dl[roots]))
    dorg0 = dl[None, :] - dl[roots][:, None]
    fm = 1.0 / rho + (w2[None, :] / (dorg0 - mid[:, None])).sum(1)
    right = (~last) & (fm < 0)
    org = np.where(right, nxt, roots)
    lo = np.where(right, -mid, 0.0)
    hi = np.where(right, 0.0, mid)
    hi[last] = rho * w2.sum()
    tau = np.where(right, -mid, mid)
    tau[last] = hi[last]
    a = np.where(last, K - 2, roots)
    b = a + 1
    dorg = dl[None, :] - dl[org][:, None]
    delta, wv, w_rest, dw_rest, dw, err = _evaluate(tau, dorg, w2, rho, org)
    done = np.abs(wv) <= eps * err
    it = 0
    while not done.all():
        if it == max_iters:
            return org, tau, delta.T, False
        act = ~done
        lo = np.where(act & (wv <= 0), np.maximum(lo, tau), lo)
        hi = np.where(act & (wv > 0), np.minimum(hi, tau), hi)
        da = delta[roots, a]
        db = delta[roots, b]
        # the two-pole model f(η) ≈ c + w_n²/(δ_n − η) + s/(δ_f − η) fitted
        # to f and f' (dlaed4's fixed weight for the pole at the origin,
        # δ_n; for the last root both poles lie left of it), in a form
        # without the near pole's terms: c = w_rest − δ_f·f'_rest
        near_a = org == a
        dn, df = np.where(near_a, da, db), np.where(near_a, db, da)
        c = w_rest - df * dw_rest
        A_ = dn * wv + df * w_rest - dn * df * dw_rest
        B_ = da * db * wv
        c = np.where(last, np.abs(c), c)
        disc = np.sqrt(np.abs(A_ * A_ - 4.0 * B_ * c))
        with np.errstate(divide="ignore", invalid="ignore"):
            eta_in = np.where(A_ <= 0, (A_ - disc) / (2.0 * c),
                              2.0 * B_ / (A_ + disc))
            eta_last = np.where(A_ >= 0, (A_ + disc) / (2.0 * c),
                                2.0 * B_ / (A_ - disc))
            eta = np.where(last, eta_last, eta_in)
            eta = np.where(c == 0, -wv / dw, eta)
            eta = np.where(wv * eta >= 0, -wv / dw, eta)
        new = tau + eta
        out = (new >= hi) | (new <= lo) | ~np.isfinite(new)
        eta = np.where(out, np.where(wv < 0, 0.5 * (hi - tau),
                                     0.5 * (lo - tau)), eta)
        tau = np.where(act, tau + eta, tau)
        delta, wv, w_rest, dw_rest, dw, err = _evaluate(tau, dorg, w2, rho, org)
        width = hi - lo
        done = done | (np.abs(wv) <= eps * err) | (
            width <= 4.0 * eps * np.maximum(np.abs(lo), np.abs(hi)))
        it += 1
    return org, tau, delta.T, True


def _merge(lam, Q, lo, mid, hi, e_s, max_iters, eps):
    s = hi - lo
    D = lam[lo:hi].copy()
    Qm = Q[lo:hi, lo:hi].copy()
    sgn = -1.0 if e_s < 0 else 1.0
    z = np.concatenate([Qm[mid - 1 - lo, :mid - lo],
                        sgn * Qm[mid - lo, mid - lo:]]) / np.sqrt(2.0)
    rho = 2.0 * abs(e_s)
    # merge the two sorted halves (ties: the left child first)
    perm = np.argsort(D, kind="stable")
    D, z, Qm = D[perm], z[perm], Qm[:, perm]
    tol = 8.0 * eps * max(np.abs(D).max(), np.abs(z).max())
    kept, defl = [], []
    pj = None
    for j in range(s):
        if rho * abs(z[j]) <= tol:
            defl.append(j)
            continue
        if pj is None:
            pj = j
            continue
        t = D[j] - D[pj]
        # |t·c·s| ≤ tol with c = z_j/τ, s = −z_p/τ, τ = hypot(z_j, z_p)
        if abs(t) * abs(z[j] * z[pj]) <= tol * (z[j] * z[j] + z[pj] * z[pj]):
            tau = np.hypot(z[j], z[pj])
            c, sn = z[j] / tau, -z[pj] / tau
            z[j], z[pj] = tau, 0.0
            x, y = Qm[:, pj].copy(), Qm[:, j].copy()
            Qm[:, pj], Qm[:, j] = c * x + sn * y, c * y - sn * x
            tp = D[pj] * c * c + D[j] * sn * sn
            D[j] = D[pj] * sn * sn + D[j] * c * c
            D[pj] = tp
            defl.append(pj)
        else:
            kept.append(pj)
        pj = j
    if pj is not None:
        kept.append(pj)
    vals, cols = [], []
    K = len(kept)
    if K:
        dl, w = D[kept], z[kept]
        org, tau, delta, ok = secular_roots(dl, w, rho, max_iters, eps)
        if not ok:
            return False
        # Gu–Eisenstat: ẑ_i² = Π_j (λ_j − d_i) / Π_{j≠i} (d_j − d_i)
        zh = np.empty(K)
        for i in range(K):
            p = -delta[i, i]
            for j in range(K):
                if j != i:
                    p *= -delta[i, j] / (dl[j] - dl[i])
            zh[i] = np.copysign(np.sqrt(abs(p)), w[i])
        U = zh[:, None] / delta
        U /= np.sqrt((U * U).sum(0))[None, :]
        vals += list(dl[org] + tau)
        cols += list((Qm[:, kept] @ U).T)
    vals += list(D[defl])
    cols += [Qm[:, j] for j in defl]
    order = np.argsort(np.asarray(vals), kind="stable")
    lam[lo:hi] = np.asarray(vals)[order]
    Q[lo:hi, lo:hi] = np.asarray(cols).T[:, order]
    return True


def divide_and_conquer(d, e, max_iters=MAX_ITERS, eps=EPS64):
    """(w ascending, Z, ok): the eigenpairs of tridiag(e, d, e)."""
    n = len(d)
    scale = max(np.abs(d).max(), np.abs(e[:n - 1]).max() if n > 1 else 0.0)
    if not np.isfinite(scale):
        return d.copy(), np.eye(n), False
    if scale == 0:
        return np.zeros(n), np.eye(n), True
    d, e = d / scale, e / scale
    lam = d.copy()
    ae = np.abs(e[:n - 1])
    lam[:-1] -= ae
    lam[1:] -= ae
    Q = np.eye(n)
    size = LEAF
    while size < n:
        for lo in range(0, n, 2 * size):
            mid, hi = lo + size, min(lo + 2 * size, n)
            if mid < hi and not _merge(lam, Q, lo, mid, hi, e[mid - 1],
                                       max_iters, eps):
                return lam, Q, False
        size *= 2
    return lam * scale, Q, True


def back_transform(R, beta, Z):
    """V = H₀ ··· H_{n−3} Z."""
    V = Z.copy()
    n = V.shape[0]
    for k in range(n - 3, -1, -1):
        if beta[k] != 0:
            v = R[k, k + 1:]
            V[k + 1:] -= beta[k] * np.outer(v, v @ V[k + 1:])
    return V


def eigh(A: np.ndarray, max_iters: int = MAX_ITERS, eps: float = EPS64):
    """(w ascending, V) of the symmetric A's lower triangle, as kernel X
    computes them; all NaN where the solve fails."""
    n = A.shape[0]
    d, e, R, beta = tridiagonalize(A)
    w, Z, ok = divide_and_conquer(d, e, max_iters, eps)
    if not ok:
        return np.full(n, np.nan), np.full((n, n), np.nan)
    return w, back_transform(R, beta, Z)
