"""JAX's counter-based random numbers, as the JAX package draws them (the
port's copy of the part of ``jax.random`` it uses: jax 0.9.0's threefry2x32
with ``jax_threefry_partitionable`` set and ``jax_high_dynamic_range_gumbel``
clear), so that the port's RANSAC masks and loop hypotheses are JAX's on the
same inputs, on the card and on the CPU alike.

* :func:`threefry2x32`: the Threefry-2x32 hash, 20 rounds (rotations
  13 15 26 6 / 17 29 16 24, key-schedule constant 0x1BD11BDA);
* :func:`key`: ``PRNGKey(seed)`` = (seed >> 32, seed & 0xFFFFFFFF);
* :func:`random_bits`: ``b1 ^ b2`` of the hash of each output's flat index
  (its high and low words), ``_threefry_random_bits_partitionable``;
* :func:`split`: key i = both words of the hash of (0, i),
  ``_threefry_split_foldlike``;
* :func:`uniform`: ``bits >> 9 | 0x3F800000`` as a float, less 1, then
  ``max(minval, f·(maxval − minval) + minval)``, ``random._uniform``;
* :func:`gumbel`: ``−log(−log(uniform(tiny, 1)))``, the "low" mode.

The plain versions compute in int64 masked to 32 bits. Kernel AQ
(``csrc/threefry.cu``, a thread an output word, no state) draws on the
card: :func:`tick_uniforms` (the camera tick's [64, F] uniforms keyed by a
device word holding the frame index, which it advances),
:func:`gumbel_noise` (a seed's [K, F] Gumbel noise) and
:func:`split_gumbel` (the loop geometry's split keys and their [K, F]
noise). Each takes the plain version for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _kernels

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA
TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 of the counts (x1, x2) under the key (k1, k2): int64
    tensors (or ints) of 32-bit words, broadcast together. Returns the two
    output words as int64 tensors in [0, 2³²)."""
    as_t = lambda v: v if isinstance(v, torch.Tensor) else torch.tensor(
        v, dtype=torch.int64)
    k1, k2, x1, x2 = (as_t(v).to(torch.int64) & MASK for v in (k1, k2, x1, x2))
    ks = (k1, k2, k1 ^ k2 ^ KS_PARITY)
    x = [(x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK]
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & MASK
    return x[0], x[1]


def key(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: [2] int64, (seed >> 32, seed & mask);
    ``seed`` an int or an integer tensor (a frame index on the device)."""
    s = torch.as_tensor(seed, device=device).to(torch.int64).reshape(())
    return torch.stack([(s >> 32) & MASK, s & MASK])


def _counts(n: int, device):
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & MASK


def random_bits(k: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits an entry of ``shape`` under the key ``k`` [..., 2]
    (a batch of keys draws ``shape`` each): int64 in [0, 2³²)."""
    shape = tuple(shape)
    hi, lo = _counts(math.prod(shape), k.device)
    k1, k2 = k[..., 0:1], k[..., 1:2]
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return (b1 ^ b2).reshape(k.shape[:-1] + shape)


def split(k: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.random.split(k, num)``: [num, 2] int64."""
    hi, lo = _counts(num, k.device)
    b1, b2 = threefry2x32(k[0], k[1], hi, lo)
    return torch.stack([b1, b2], -1)


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """[1, 2) less 1: the mantissa's 23 bits from the top of ``bits``."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(k: torch.Tensor, shape, minval: float = TINY,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``."""
    f = bits_to_unit(random_bits(k, shape))
    lo = torch.tensor(minval, dtype=torch.float32)
    span = torch.tensor(maxval, dtype=torch.float32) - lo
    return torch.maximum(f * span.to(f.device) + lo.to(f.device),
                         lo.to(f.device))


def gumbel(k: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel(k, shape)`` (float32, the low mode)."""
    return -torch.log(-torch.log(uniform(k, shape, TINY, 1.0)))


# ------------------------------------------------------------- kernel AQ
def tick_uniforms_plain(word: torch.Tensor, hypotheses: int, n: int):
    return uniform(key(word), (hypotheses, n)), word + 1


def tick_uniforms(word: torch.Tensor, hypotheses: int, n: int):
    """The camera tick's RANSAC uniforms ``uniform(PRNGKey(frame_idx),
    (hypotheses, n), tiny, 1)`` [hypotheses, n], keyed by ``word`` (an int32
    [] tensor holding the frame index, on the tick's device), and the next
    frame's word (``word + 1``). Kernel AQ on the card: the same launch a
    tick, whatever the frame."""
    if not word.is_cuda:
        return tick_uniforms_plain(word, hypotheses, n)
    if word.dtype != torch.int32 or word.numel() != 1:
        raise ValueError("kernel AQ: the frame word is one int32")
    dev = word.device
    out = torch.empty((hypotheses, n), dtype=torch.float32, device=dev)
    nxt = torch.empty_like(word)
    _draw(dev, ctypes.c_void_p(word.data_ptr()), 0, hypotheses, n, 0, out,
          ctypes.c_void_p(nxt.data_ptr()))
    return out, nxt


def gumbel_noise_plain(seed: int, hypotheses: int, n: int, device):
    return gumbel(key(seed, device), (hypotheses, n))


def gumbel_noise(seed: int, hypotheses: int, n: int, device) -> torch.Tensor:
    """``jax.random.gumbel(PRNGKey(seed), (hypotheses, n))`` on ``device``
    (RANSAC's noise, the JAX tracker's ``ransac_f_reject``): kernel AQ on
    the card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return gumbel_noise_plain(seed, hypotheses, n, dev)
    out = torch.empty((hypotheses, n), dtype=torch.float32, device=dev)
    _draw(dev, ctypes.c_void_p(None), int(seed), hypotheses, n, 1, out,
          ctypes.c_void_p(None))
    return out


def _draw(dev, word, seed, hypotheses, n, as_gumbel, out, nxt):
    if not 0 <= seed <= MASK:
        raise ValueError("kernel AQ: a seed of 32 bits")
    err = _kernels.library().gf2_threefry_draw(
        word, seed, hypotheses, n, as_gumbel, ctypes.c_float(TINY),
        ctypes.c_void_p(out.data_ptr()), nxt,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _kernels.check(err, "gf2_threefry_draw")
    _kernels.count("threefry")


def split_gumbel_plain(seed: int, hypotheses: int, n: int, device):
    keys = split(key(seed, device), hypotheses)
    return keys, gumbel(keys, (n,))


def split_gumbel(seed: int, hypotheses: int, n: int, device):
    """The loop geometry's noise: (the keys of ``split(PRNGKey(seed),
    hypotheses)`` [hypotheses, 2] int64, ``gumbel(k_i, (n,))`` of each
    [hypotheses, n]). Kernel AQ's split mode on the card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return split_gumbel_plain(seed, hypotheses, n, dev)
    if not 0 <= int(seed) < 1 << 63:
        raise ValueError("kernel AQ: a seed of 64 bits at most")
    k = key(int(seed))
    keys = torch.empty((hypotheses, 2), dtype=torch.int64, device=dev)
    g = torch.empty((hypotheses, n), dtype=torch.float32, device=dev)
    err = _kernels.library().gf2_threefry_split_gumbel(
        int(k[0]), int(k[1]), hypotheses, n, ctypes.c_float(TINY),
        ctypes.c_void_p(keys.data_ptr()), ctypes.c_void_p(g.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _kernels.check(err, "gf2_threefry_split_gumbel")
    _kernels.count("threefry")
    return keys, g
