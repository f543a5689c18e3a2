"""Which order of operations PyTorch's ops take on this device, for the
small reductions, cross products and matrix products of the LiDAR tick's
glue (kernels AK, AL, AM replay them bit for bit) and of the camera tick's
(kernel AN's retraction of the window, kernel AO's GNSS gate), and for the
norms of kernel AH's rays.

    PYTHONPATH=. python3 tools/probe_torch_orders.py [--device cuda] [--n 65536]

For each op at the shape the tick calls it with, every candidate order is
evaluated with float32 elementwise ops (one rounding each) and, for a fused
multiply-add, in float64 rounded once to float32; the line printed per op
gives each candidate's share of the trials that equal the op's result bit
for bit. The last line is one JSON object of all of them.
"""

import argparse
import json
import sys

import torch


def fma(a, b, c):
    """float32 fma(a, b, c): the float64 product is exact, the sum rounds
    once in float64 and once to float32 (a double rounding only where the
    float64 sum lies on a float32 tie, which random inputs do not hit)."""
    return (a.double() * b.double() + c.double()).float()


def share(ref, cand) -> float:
    eq = (ref == cand) | (torch.isnan(ref) & torch.isnan(cand))
    return float(eq.float().mean())


def sums(x, n: int) -> dict:
    a = [x[..., i] for i in range(n)]
    if n == 3:
        return {"(0+1)+2": (a[0] + a[1]) + a[2], "(0+2)+1": (a[0] + a[2]) + a[1],
                "0+(1+2)": a[0] + (a[1] + a[2])}
    return {"((0+1)+2)+3": ((a[0] + a[1]) + a[2]) + a[3],
            "(0+1)+(2+3)": (a[0] + a[1]) + (a[2] + a[3]),
            "(0+2)+(1+3)": (a[0] + a[2]) + (a[1] + a[3]),
            "((0+2)+1)+3": ((a[0] + a[2]) + a[1]) + a[3]}


def norms(x, n: int) -> dict:
    out = {f"sqrt {k}": torch.sqrt(v) for k, v in sums(x * x, n).items()}
    a = [x[..., i] for i in range(n)]
    r = [v * v for v in a]
    if n == 3:
        out["sqrt fma(2,2,0²)+1²"] = torch.sqrt(fma(a[2], a[2], r[0]) + r[1])
        out["sqrt fma(2,2,fma(1,1,0²))"] = torch.sqrt(
            fma(a[2], a[2], fma(a[1], a[1], r[0])))
    else:
        out["sqrt fma chain"] = torch.sqrt(
            fma(a[3], a[3], fma(a[2], a[2], fma(a[1], a[1], r[0]))))
        out["sqrt fma(2,2,0²)+fma(3,3,1²)"] = torch.sqrt(
            fma(a[2], a[2], r[0]) + fma(a[3], a[3], r[1]))
    return out


def dots(A, B) -> dict:
    """C = A @ B candidates: A [..., m, k], B [..., k, n]."""
    k = A.shape[-1]
    p = [A[..., :, j:j + 1] * B[..., j:j + 1, :] for j in range(k)]
    Ak = [A[..., :, j:j + 1] for j in range(k)]
    Bk = [B[..., j:j + 1, :] for j in range(k)]
    chain = p[0]
    seq = p[0]
    rev = p[k - 1]
    for j in range(1, k):
        chain = fma(Ak[j].expand_as(p[0]), Bk[j].expand_as(p[0]), chain)
        seq = seq + p[j]
        i = k - 1 - j
        rev = fma(Ak[i].expand_as(p[0]), Bk[i].expand_as(p[0]), rev)
    out = {"fma chain 0..k-1": chain, "mul-add 0..k-1": seq,
           "fma chain k-1..0": rev}
    # a warp's shuffle trees over one product a lane
    lanes = list(p) + [torch.zeros_like(p[0])] * (32 - k)
    xor = list(lanes)
    for off in (16, 8, 4, 2, 1):
        xor = [xor[i] + xor[i ^ off] for i in range(32)]
    down = list(lanes)
    off = 1
    while off < 32:
        down = [down[i] + (down[i + off] if i + off < 32 else 0 * down[i])
                for i in range(32)]
        off <<= 1
    out["warp xor tree"] = xor[0]
    out["warp down tree"] = down[0]
    if k % 2 == 0:
        h = k // 2
        c0, c1 = p[0], p[h]
        for j in range(1, h):
            c0 = fma(Ak[j].expand_as(p[0]), Bk[j].expand_as(p[0]), c0)
            c1 = fma(Ak[h + j].expand_as(p[0]), Bk[h + j].expand_as(p[0]), c1)
        out["two halves' fma chains, summed"] = c0 + c1
        e, o = p[0], p[1]
        for j in range(2, k, 2):
            e = fma(Ak[j].expand_as(p[0]), Bk[j].expand_as(p[0]), e)
            o = fma(Ak[j + 1].expand_as(p[0]), Bk[j + 1].expand_as(p[0]), o)
        out["even / odd fma chains, summed"] = e + o
    return out


def _tree(parts, how: str):
    """Sum partial results: "seq" left to right, "pair" adjacent pairs a
    level, "xor" / "down" as a warp's shuffles over len(parts) lanes (a
    power of two or padded with zeros)."""
    if how == "seq":
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out
    if how == "rseq":
        out = parts[-1]
        for p in parts[-2::-1]:
            out = out + p
        return out
    if how == "pair":
        while len(parts) > 1:
            parts = [parts[i] + parts[i + 1] if i + 1 < len(parts) else parts[i]
                     for i in range(0, len(parts), 2)]
        return parts[0]
    w = 1
    while w < len(parts):
        w <<= 1
    lanes = list(parts) + [None] * (w - len(parts))
    add = lambda a, b: a if b is None else (b if a is None else a + b)
    if how == "xor":
        off = w >> 1
        while off:
            lanes = [add(lanes[i], lanes[i ^ off]) for i in range(w)]
            off >>= 1
    else:
        off = 1
        while off < w:
            lanes = [add(lanes[i], lanes[i + off] if i + off < w else None)
                     for i in range(w)]
            off <<= 1
    return lanes[0]


def split_dots(A, B) -> dict:
    """C = A @ B with the k terms split among P partial fma chains
    (contiguous chunks or interleaved), the partials summed by each tree of
    :func:`_tree`."""
    k = A.shape[-1]
    Ak = [A[..., :, j:j + 1] for j in range(k)]
    Bk = [B[..., j:j + 1, :] for j in range(k)]
    shape = (A[..., :, :1] * B[..., :1, :]).shape

    def chain(idx):
        acc = (Ak[idx[0]] * Bk[idx[0]]).expand(shape)
        for j in idx[1:]:
            acc = fma(Ak[j].expand(shape), Bk[j].expand(shape), acc)
        return acc
    out = {}
    for P in range(2, k + 1):
        c = -(-k // P)
        groups = {"chunks": [list(range(i, min(i + c, k)))
                             for i in range(0, k, c)],
                  "interleaved": [list(range(t, k, P)) for t in range(P)]}
        for gname, gs in groups.items():
            gs = [g for g in gs if g]
            parts = [chain(g) for g in gs]
            for how in ("seq", "rseq", "pair", "xor", "down"):
                out[f"{gname} P={P} {how}"] = _tree(parts, how)
    # sliced tiles: the k loop in tiles of BK, slice w of S taking BK/S of
    # each tile's k (contiguous or strided), the slices' chains summed
    for BK in (2, 4, 8, 16, 32):
        for S in (2, 4, 8):
            if BK % S or BK // S < 1:
                continue
            w_ = BK // S
            for kind in ("contiguous", "strided"):
                gs = []
                for w in range(S):
                    idx = []
                    for t0 in range(0, k, BK):
                        own = (range(t0 + w * w_, t0 + (w + 1) * w_)
                               if kind == "contiguous"
                               else range(t0 + w, t0 + BK, S))
                        idx += [j for j in own if j < k]
                    gs.append(idx)
                gs = [g for g in gs if g]
                if len(gs) < 2:
                    continue
                parts = [chain(g) for g in gs]
                for how in ("seq", "rseq", "pair", "xor", "down"):
                    out[f"tiles BK={BK} S={S} {kind} {how}"] = _tree(parts, how)
    return out


def small_sums(x) -> dict:
    """torch.sum of a contiguous vector x [..., n] (n ≤ 32) as a CUDA
    reduce may take it: B lanes, lane l adding entries l, l + B, ... into
    vt slots in turn, the slots combined in order, the lanes by a shuffle
    tree with ascending or descending offsets; and the plain orders."""
    n = x.shape[-1]
    a = [x[..., i] for i in range(n)]
    out = {"seq": _tree(a, "seq"), "pair": _tree(a, "pair")}
    for B in (1, 2, 4, 8, 16, 32):
        for vt in (1, 2, 4):
            lanes = []
            for lane in range(B):
                slots = [torch.zeros_like(a[0]) for _ in range(vt)]
                for i, j in enumerate(range(lane, n, B)):
                    slots[i % vt] = slots[i % vt] + a[j]
                v = slots[0]
                for sl in slots[1:]:
                    v = v + sl
                lanes.append(v)
            for how, name in (("down", "ascending"), ("xor", "descending")):
                out[f"B={B} vt={vt} {name}"] = _tree(lanes, how)
    return out


def cross(a, b) -> dict:
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    st = lambda *c: torch.stack(c, -1)
    return {
        "a*b - c*d": st(a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0),
        "fma(a, b, -(c*d))": st(fma(a1, b2, -(a2 * b1)), fma(a2, b0, -(a0 * b2)),
                                fma(a0, b1, -(a1 * b0))),
        "fma(-c, d, a*b)": st(fma(-a2, b1, a1 * b2), fma(-a0, b2, a2 * b0),
                              fma(-a1, b0, a0 * b1)),
    }


def probe(dev, n: int, seed: int = 0, only_best: bool = True) -> dict:
    g = torch.Generator(device="cpu").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g).to(dev)
    res = {}

    def row(name, ref, cands):
        res[name] = {k: share(ref, v) for k, v in cands.items()}
        best = max(res[name].items(), key=lambda kv: kv[1])
        print(f"{name}: " + json.dumps(res[name]) + f"  -> {best[0]}",
              flush=True)

    # torch.sum(x, -1) over rows of 3 and 4: many rows, one row ([3], [1, 4])
    x3, x4 = r(n, 3), r(n, 4)
    row("sum [n,3] dim -1", torch.sum(x3, -1), sums(x3, 3))
    row("sum [n,4] dim -1", torch.sum(x4, -1), sums(x4, 4))
    one3 = torch.stack([torch.sum(x3[i], -1) for i in range(256)])
    row("sum [3] dim -1 (one row a call)", one3, sums(x3[:256], 3))
    one4 = torch.stack([torch.sum(x4[i:i + 1], -1, keepdim=True)[0, 0]
                        for i in range(256)])
    row("sum [1,4] dim -1 keepdim (one row a call)", one4, sums(x4[:256], 4))
    # torch.linalg.norm over rows of 3 and 4
    row("norm [n,4] dim -1", torch.linalg.norm(x4, dim=-1), norms(x4, 4))
    row("norm [n,3] dim -1", torch.linalg.norm(x3, dim=-1), norms(x3, 3))
    one3 = torch.stack([torch.linalg.norm(x3[i]) for i in range(256)])
    row("norm [3] (one vector a call)", one3, norms(x3[:256], 3))
    one4 = torch.stack([torch.linalg.norm(x4[i], dim=-1, keepdim=True)[0]
                        for i in range(256)])
    row("norm [4] dim -1 keepdim (one vector a call)", one4, norms(x4[:256], 4))
    # torch.linalg.cross on rows of 3
    a, b = r(n, 3), r(n, 3)
    row("cross [n,3]", torch.linalg.cross(a, b, dim=-1), cross(a, b))
    # matrix products as the tick calls them, one call each
    shapes = {"mm [4,4]@[4,1] (quat_mul)": (4, 4, 1),
              "mm [18,6]@[6,6] (K = P Hᵀ S⁻¹)": (18, 6, 6),
              "mm [18,18]@[18,18] ((I - K H) P)": (18, 18, 18)}
    for name, (m, k, nn) in shapes.items():
        A = [r(m, k) for _ in range(64)]
        B = [r(k, nn) for _ in range(64)]
        ref = torch.stack([x @ y for x, y in zip(A, B)])
        At, Bt = torch.stack(A), torch.stack(B)
        cands = {**dots(At, Bt), **split_dots(At, Bt)}
        if only_best:
            res[name] = {kk: share(ref, v) for kk, v in cands.items()}
            top = sorted(res[name].items(), key=lambda kv: -kv[1])[:8]
            print(f"{name}: " + json.dumps(dict(top)), flush=True)
            continue
        row(name, ref, cands)
    A = [r(18, 6) for _ in range(256)]
    v = [r(6) for _ in range(256)]
    ref = torch.stack([x @ y for x, y in zip(A, v)])
    cands = dots(torch.stack(A), torch.stack(v)[..., None])
    row("mv [18,6]@[6] (K innov)", ref, {kk: c[..., 0]
                                        for kk, c in cands.items()})
    # the camera tick's shapes (W = 11 frames): lie.quat_exp's and
    # quat_normalize's reductions and quat_mul's product over the window's
    # rotations (WindowLayout.retract), the GNSS gate's speeds and their sum
    W = 11
    xs = [r(W, 3) for _ in range(256)]
    row("sum [11,3] dim -1 keepdim (the window's quat_exp)",
        torch.stack([torch.sum(x, -1, keepdim=True)[:, 0] for x in xs]),
        sums(torch.stack(xs), 3))
    row("norm [11,3] dim -1 (the GNSS gate's speeds)",
        torch.stack([torch.linalg.norm(x, dim=-1) for x in xs]),
        norms(torch.stack(xs), 3))
    x4s = [r(W, 4) for _ in range(256)]
    row("norm [11,4] dim -1 keepdim (the window's quat_normalize)",
        torch.stack([torch.linalg.norm(x, dim=-1, keepdim=True)[:, 0]
                     for x in x4s]), norms(torch.stack(x4s), 4))
    # kernel AH's rays at F = 150 slots: (x, y, 1) for the pinhole models,
    # rows with any z for Equidistant (cos θ), Mei (zs − xi) and
    # Scaramuzza (−poly)
    for name, z in (("z = 1", 1.0), ("any z", None)):
        xs = [r(150, 3) for _ in range(256)]
        if z is not None:
            xs = [torch.cat([x[:, :2], torch.ones_like(x[:, 2:])], -1)
                  for x in xs]
        row(f"norm [150,3] dim -1 keepdim ({name}: kernel AH's rays)",
            torch.stack([torch.linalg.norm(x, dim=-1, keepdim=True)[:, 0]
                         for x in xs]), norms(torch.stack(xs), 3))
    A = [r(W, 4, 4) for _ in range(64)]
    B = [r(W, 4, 1) for _ in range(64)]
    ref = torch.stack([x @ y for x, y in zip(A, B)])
    At, Bt = torch.stack(A), torch.stack(B)
    cands = {**dots(At, Bt), **split_dots(At, Bt)}
    name = "bmm [11,4,4]@[11,4,1] (the window's quat_mul)"
    res[name] = {kk: share(ref, v) for kk, v in cands.items()}
    top = sorted(res[name].items(), key=lambda kv: -kv[1])[:8]
    print(f"{name}: " + json.dumps(dict(top)), flush=True)
    vs = [r(W).abs() for _ in range(2048)]
    ref = torch.stack([v.sum() for v in vs])
    cands = small_sums(torch.stack(vs))
    name = "sum [11] (the GNSS gate's mean speed)"
    res[name] = {kk: share(ref, v) for kk, v in cands.items()}
    top = sorted(res[name].items(), key=lambda kv: -kv[1])[:8]
    print(f"{name}: " + json.dumps(dict(top)), flush=True)
    # a float32 tensor divided by a Python float: by its float reciprocal?
    x = r(n)
    for s in (48.0, 8.0, 3.0, 0.2):
        row(f"x / {s}", x / s, {
            "x * f32(1/s)": x * torch.tensor(1.0, device=dev)
            / torch.tensor(s, device=dev),
            "x / f32(s)": x / torch.tensor(s, device=dev)})
    return res


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=65536)
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("probe_torch_orders: no CUDA device", file=sys.stderr)
        return 1
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          + (torch.cuda.get_device_name(0) if args.device.startswith("cuda")
             else "cpu"), flush=True)
    res = probe(torch.device(args.device), args.n)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
