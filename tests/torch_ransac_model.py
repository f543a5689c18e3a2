"""A numpy model of kernel K's solve (``ground_fusion2_tpu_torch/csrc/ransac_f.cu``),
step for step: the 8 samples by 8 rounds of arg-max (the lower index on
ties, each pick struck out), Hartley's normalization, the 8×9 system padded
to 8×10, the one-sided (Hestenes) Jacobi on its columns in the kernel's
round-robin order (a ring of columns on the warp's lane groups) with its
stopping test and sweep cap, the null vector as
V's column of the smallest ‖A·v‖, and rank 2 by the same Jacobi on Fn's 3
columns. The algorithm is debugged here on the CPU;
``tests/test_torch_ransac_model.py`` holds it against ``numpy.linalg.svd``
and the kernel's constants.
"""

from __future__ import annotations

import numpy as np

CAP = 32        # the kernel's kCap: Jacobi sweeps
EPS = 1e-14     # and kEps: a pair is orthogonal at |a_p·a_q| ≤ EPS‖a_p‖‖a_q‖


def sample(g: np.ndarray, n: int = 8) -> np.ndarray:
    """Indices of the n largest of g [F], largest first, the lower index on
    ties: the kernel's n rounds of a warp arg-max."""
    g = np.array(g, dtype=np.float32)
    out = []
    for _ in range(n):
        i = int(np.argmax(g))        # numpy: the first of the largest
        out.append(i)
        g[i] = -np.inf
    return np.array(out)


def pairs(NP: int, s: int):
    """Step s of the kernel's round robin over NP columns (the last one the
    zero pad): the NC = NP − 1 real columns on a ring P0..P(NC−1), pair k =
    1..NP/2 − 1 is (P(k−1), P(NC−1−k)) as (top, bottom), P(NC−1) idles, and
    each step moves every column one position on (P(NC−1) to P0)."""
    NC = NP - 1
    ring = list(range(NC))
    for _ in range(s % NC):
        ring = [ring[-1]] + ring[:-1]
    return [(ring[k - 1], ring[NC - 1 - k]) for k in range(1, NP // 2)]


def jacobi(M: np.ndarray, eps: float = EPS, cap: int = CAP):
    """One-sided Jacobi on the columns of M [rows, NP] (column NP − 1 zero):
    returns (M·V, V [NC, NC], the sweeps that turned a pair)."""
    M = np.array(M, dtype=np.float64)
    NP = M.shape[1]
    NC = NP - 1
    V = np.eye(NC)
    floor2 = eps * eps * float(np.sum(M * M))
    sweeps = 0
    while sweeps < cap:
        turned = False
        for s in range(NC):
            for p, q in pairs(NP, s):
                ap, aq = M[:, p].copy(), M[:, q].copy()    # top, bottom
                al, be, ga = ap @ ap, aq @ aq, ap @ aq
                if not (ga * ga > eps * eps * al * be and al > floor2
                        and be > floor2):
                    continue
                # tan θ: the smaller root of t² + 2ζt − 1, ζ = d / (2γ),
                # as c = u / sqrt(2ru), s = sgn(d)·2γ / sqrt(2ru)
                d = be - al
                r = np.sqrt(d * d + 4.0 * ga * ga)
                u = abs(d) + r
                w = 1.0 / np.sqrt(2.0 * r * u)
                c, sn = u * w, (2.0 if d >= 0.0 else -2.0) * ga * w
                M[:, p], M[:, q] = c * ap - sn * aq, sn * ap + c * aq
                vp, vq = V[:, p].copy(), V[:, q].copy()
                V[:, p], V[:, q] = c * vp - sn * vq, sn * vp + c * vq
                turned = True
        if not turned:
            break
        sweeps += 1
    return M, V, sweeps


def smallest_column(M: np.ndarray) -> int:
    """The real column of the smallest norm, the lower index on ties."""
    n2 = np.sum(M[:, :-1] ** 2, axis=0)
    return int(np.argmin(n2))


def hartley(p: np.ndarray):
    """p [8, 2] -> T [3, 3] (centroid, s = sqrt(2) / mean distance)."""
    c = p.mean(0)
    d = np.mean(np.sqrt(np.sum((p - c) ** 2, axis=1))) + 1e-9
    s = np.sqrt(2.0) / d
    return np.array([[s, 0.0, -s * c[0]], [0.0, s, -s * c[1]], [0.0, 0.0, 1.0]])


def system(p1: np.ndarray, p2: np.ndarray):
    """The normalized 8×9 system A padded to 8×10, T1, T2."""
    T1, T2 = hartley(p1), hartley(p2)
    x1 = T1[0, 0] * p1[:, 0] + T1[0, 2]
    y1 = T1[1, 1] * p1[:, 1] + T1[1, 2]
    x2 = T2[0, 0] * p2[:, 0] + T2[0, 2]
    y2 = T2[1, 1] * p2[:, 1] + T2[1, 2]
    one = np.ones_like(x1)
    A = np.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one,
                  0.0 * one], 1)
    return A, T1, T2


def eight_point(p1: np.ndarray, p2: np.ndarray) -> dict:
    """The kernel's solve of one hypothesis from its 8 samples [8, 2] x2:
    the null vector ``f`` [9], the rank-2 normalized ``Fn2``, the
    de-normalized ``F`` [3, 3] and the sweeps of both Jacobis."""
    A, T1, T2 = system(np.asarray(p1, np.float64), np.asarray(p2, np.float64))
    AV, V, sw9 = jacobi(A)
    f = V[:, smallest_column(AV)]
    B = np.zeros((4, 4))
    B[:3, :3] = f.reshape(3, 3)
    BV, V3, sw3 = jacobi(B)
    v = V3[:, smallest_column(BV)]
    Fn = f.reshape(3, 3)
    Fn2 = Fn - np.outer(Fn @ v, v)
    return dict(f=f, Fn2=Fn2, F=T2.T @ Fn2 @ T1, sweeps=(sw9, sw3), A=A[:, :9])


def svd_reference(p1: np.ndarray, p2: np.ndarray) -> dict:
    """The same through ``numpy.linalg.svd``, as JAX's ``_eight_point``."""
    A, T1, T2 = system(np.asarray(p1, np.float64), np.asarray(p2, np.float64))
    f = np.linalg.svd(A[:, :9], full_matrices=True)[2][-1]
    U, S, Vh = np.linalg.svd(f.reshape(3, 3))
    Fn2 = (U * np.array([S[0], S[1], 0.0])) @ Vh
    return dict(f=f, Fn2=Fn2, F=T2.T @ Fn2 @ T1)


def unit_sign(x: np.ndarray) -> np.ndarray:
    """x / |x|, the sign fixed so that the largest |entry| is positive."""
    x = np.asarray(x, np.float64).reshape(-1)
    x = x / np.linalg.norm(x)
    return x * np.sign(x[np.argmax(np.abs(x))])
