"""JAX's seeded Bernoulli draw, bit for bit, in torch.

The GD comparator (``core/gd.py``) samples each iteration's mini-batch as
``jax.random.bernoulli(jax.random.fold_in(jax.random.PRNGKey(seed), it),
p, (rows,))``.  This module reproduces those bits without JAX:

- threefry-2x32 with 20 rounds (``jax/_src/prng.py``,
  ``_threefry2x32_lowering``);
- ``PRNGKey(seed)``: the 64-bit seed split into its high and low words
  (``_threefry_seed``); ``fold_in(key, data)``: the hash of the counter
  pair ``(0, data)`` under ``key`` (``_threefry_fold_in``);
- the random bits over a 64-bit ``iota`` counter split into
  ``(hi, lo)`` words, as ``jax_threefry_partitionable`` (on by default
  since jax 0.5) draws them (``_threefry_random_bits_partitionable``):
  32-bit words are ``bits1 ^ bits2``, 64-bit words ``bits1 << 32 |
  bits2``;
- ``uniform``'s mantissa fill (the top ``nmant`` bits of a word as the
  fraction of a float in ``[1, 2)``, minus one), then ``< p``
  (``_uniform``, ``_bernoulli``).

**Width of the draw.** JAX draws words as wide as ``p``'s dtype, not the
weights'.  Under x64 a Python-float ``p`` is f64, so the JAX package
draws 64-bit words even for f32 weights; without x64 (the TPU's
production mode) it draws 32-bit words.  :func:`bernoulli` takes the
width from ``dtype``, and ``core.gd`` passes the carry dtype: an f64
carry draws 64-bit words (the reference under x64), an f32 carry 32-bit
words (the reference without x64, equal to
``jax.random.bernoulli(key, jnp.float32(p), shape)``).

Words are held in int64 tensors masked to 32 bits (CUDA's unsigned
32-bit shifts are thin in torch); ``u < p`` is compared in integers, as
``v < ceil(p * 2**nmant)`` for the word's top ``nmant`` bits ``v``,
which is exact.  Seeds are taken as 64-bit integers, as under x64.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0: int, k1: int, x0, x1):
    """The threefry-2x32 hash (20 rounds) of the counter words ``(x0,
    x1)`` under the key ``(k0, k1)``; the counters are Python ints or
    int64 tensors holding 32-bit values."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & _M32
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` as a pair of 32-bit words."""
    s = int(seed) & ((1 << 64) - 1)
    return s >> 32, s & _M32


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)`` (``data`` as a uint32)."""
    return threefry2x32(key[0], key[1], 0, int(data) & _M32)


def random_bits(key: tuple[int, int], n: int, device):
    """The hash words ``(bits1, bits2)`` of JAX's partitionable threefry
    over the counters ``0 .. n-1`` (split into high and low words), as
    int64 tensors on ``device``; a 32-bit word is ``bits1 ^ bits2``, a
    64-bit one ``bits1 << 32 | bits2``."""
    counts = torch.arange(n, dtype=torch.int64, device=device)
    return threefry2x32(key[0], key[1], counts >> 32, counts & _M32)


def bernoulli(key: tuple[int, int], p: float, n: int, *, dtype,
              device) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, (n,))`` with ``p`` of ``dtype``
    (f32: 32-bit words; f64: 64-bit words): a bool tensor on
    ``device``."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the draw is f32 or f64, got {dtype}")
    bits1, bits2 = random_bits(key, n, device)
    if dtype == torch.float32:  # the top 23 bits of bits1 ^ bits2
        nmant, v = 23, (bits1 ^ bits2) >> 9
    else:  # the top 52 bits of bits1 << 32 | bits2
        nmant, v = 52, (bits1 << 20) | (bits2 >> 12)
    # p rounded to the draw's dtype, as JAX converts it; u = v / 2**nmant
    p_cast = float(torch.tensor(float(p), dtype=dtype))
    return v < math.ceil(p_cast * 2.0 ** nmant)


def sample_mask(seed: int, it: int, p: float, n: int, *, dtype,
                device) -> torch.Tensor:
    """The mini-batch mask of GD iteration ``it`` (1-based) as ``dtype``
    0/1 values: ``bernoulli(fold_in(PRNGKey(seed), it), p, (n,))``."""
    key = fold_in(prng_key(seed), it)
    return bernoulli(key, p, n, dtype=dtype, device=device).to(dtype)


def split(key: tuple[int, int]) -> tuple[tuple[int, int], tuple[int, int]]:
    """``jax.random.split(key)`` (two keys) under the partitionable
    threefry: the hash of the counters ``(0, 0)`` and ``(0, 1)``
    (``_threefry_split_foldlike``)."""
    b1, b2 = threefry2x32(key[0], key[1], 0, 0)
    c1, c2 = threefry2x32(key[0], key[1], 0, 1)
    return (b1, b2), (c1, c2)


def permutation(seed: int, n: int, device) -> torch.Tensor:
    """``jax.random.permutation(jax.random.PRNGKey(seed), n)`` as an
    int64 tensor on ``device``.  JAX shuffles ``arange(n)`` by rounds
    (``random._shuffle``): each splits the key, draws 32-bit words over
    the rows and sorts the values by them, stably; there are
    ``ceil(3 ln n / ln(2**32 - 1))`` rounds."""
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(_M32)))
    key = prng_key(seed)
    x = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(rounds):
        key, sub = split(key)
        bits1, bits2 = random_bits(sub, n, device)
        order = torch.sort(bits1 ^ bits2, stable=True).indices
        x = x[order]
    return x
