"""Mod-2^64 torus arithmetic as (hi, lo) uint32 limb pairs.

64-bit integers need JAX's x64 mode, a global config, so the TFHE torus
T_q with q = 2^64 is represented explicitly as two uint32 limbs.  uint32
add/mul/shift wrap mod 2^32 in XLA, which is exactly the carry-friendly
behavior needed.  All functions are elementwise over arbitrary leading
shapes and jit/vmap/scan-friendly.

This module replaces the role of the 64-bit integer scalar loops inside the
Concrete/TFHE-rs native runtime (the execution engine the reference calls
through ``q_module.forward``; reference homomorphic_eval.py:70).
"""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32


class T64(NamedTuple):
    """A tensor of torus elements: value = hi * 2^32 + lo (mod 2^64)."""
    hi: jax.Array  # uint32
    lo: jax.Array  # uint32

    @property
    def shape(self):
        return self.hi.shape


def t64(hi, lo) -> T64:
    return T64(jnp.asarray(hi, U32), jnp.asarray(lo, U32))


def zeros(shape) -> T64:
    z = jnp.zeros(shape, U32)
    return T64(z, z)


# -- numpy interop -----------------------------------------------------------

def from_u64(x: np.ndarray) -> T64:
    x = np.asarray(x, np.uint64)
    return T64(jnp.asarray((x >> np.uint64(32)).astype(np.uint32)),
               jnp.asarray((x & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


def to_u64(x: T64) -> np.ndarray:
    hi = np.asarray(jax.device_get(x.hi), np.uint64)
    lo = np.asarray(jax.device_get(x.lo), np.uint64)
    return (hi << np.uint64(32)) | lo


# -- ring ops ----------------------------------------------------------------

def add(a: T64, b: T64) -> T64:
    lo = a.lo + b.lo
    carry = (lo < a.lo).astype(U32)
    return T64(a.hi + b.hi + carry, lo)


def sub(a: T64, b: T64) -> T64:
    borrow = (a.lo < b.lo).astype(U32)
    return T64(a.hi - b.hi - borrow, a.lo - b.lo)


def neg(a: T64) -> T64:
    lo = (~a.lo) + U32(1)
    carry = (lo == 0).astype(U32)
    return T64((~a.hi) + carry, lo)


def select(pred, a: T64, b: T64) -> T64:
    """Elementwise where(pred, a, b)."""
    return T64(jnp.where(pred, a.hi, b.hi), jnp.where(pred, a.lo, b.lo))


def _mulhilo32(x, y):
    """Full 32x32 -> 64 product of uint32 tensors, via 16-bit splits."""
    xl = x & U32(0xFFFF)
    xh = x >> U32(16)
    yl = y & U32(0xFFFF)
    yh = y >> U32(16)
    t = xl * yl
    u = xh * yl + (t >> U32(16))
    v = xl * yh + (u & U32(0xFFFF))
    hi = xh * yh + (u >> U32(16)) + (v >> U32(16))
    lo = (v << U32(16)) + (t & U32(0xFFFF))
    return hi, lo


def scalar_mul(a: T64, m) -> T64:
    """a * m (mod 2^64) for signed int32 scalars/tensors m.

    m is interpreted mod 2^64 (negative m -> 2^64 + m), matching integer
    weight multiplication of LWE ciphertexts.
    """
    m = jnp.asarray(m)
    m_u = m.astype(U32)
    hi_p, lo = _mulhilo32(a.lo, m_u)
    hi = hi_p + a.hi * m_u
    # For negative m, (m mod 2^64) has high limb 0xFFFFFFFF: add (-1)*a.lo
    # to the high limb ( -(a.lo << 32) == (~a.lo + 1) << 32 in the hi slot).
    is_neg = m < 0
    hi = jnp.where(is_neg, hi - a.lo, hi)
    return T64(hi, lo)


def shift_left(a: T64, k: int) -> T64:
    """a << k (mod 2^64), static k in [0, 64)."""
    if k == 0:
        return a
    if k >= 32:
        return T64(a.lo << U32(k - 32) if k > 32 else a.lo, jnp.zeros_like(a.lo))
    return T64((a.hi << U32(k)) | (a.lo >> U32(32 - k)), a.lo << U32(k))


def from_i32_shifted(v, k: int) -> T64:
    """(int32 v) * 2^k  (mod 2^64), sign-extended; static k in [0, 64)."""
    v = jnp.asarray(v, jnp.int32)
    lo = v.astype(U32)
    hi = (v >> 31).astype(U32)          # sign extension
    return shift_left(T64(hi, lo), k)


def round_shift_right(a: T64, k: int) -> int:
    """round(a / 2^k) as uint32 (requires 64 - k <= 32), i.e. the top
    (64-k) bits with round-half-up.  Used for modulus switching."""
    assert 64 - k <= 32
    half = shift_left(t64(jnp.zeros_like(a.hi), jnp.ones_like(a.lo)), k - 1)
    r = add(a, half)
    if k == 32:
        return r.hi
    if k > 32:
        return r.hi >> U32(k - 32)
    return (r.hi << U32(32 - k)) | (r.lo >> U32(k))


# -- gadget decomposition ----------------------------------------------------

def decompose(a: T64, base_log: int, levels: int):
    """Signed gadget decomposition (closest representative).

    Returns int32 digits d_1..d_l with d_i in [-B/2, B/2], B = 2^base_log,
    such that  sum_i d_i * 2^(64 - i*base_log)  ~=  a  (up to the rounding
    remainder q / B^l).  Matches the standard TFHE decomposition used for
    external products and keyswitching.

    Output shape: (levels, *a.shape), dtype int32.
    """
    B = base_log
    total = B * levels
    assert total <= 32, "levels*base_log <= 32 (sufficient for q=2^64 presets)"
    # Round a to the nearest multiple of 2^(64-total): take top `total` bits.
    top = round_shift_right(a, 64 - total)
    mask = U32((1 << B) - 1)
    half = U32(1 << (B - 1))

    digits = []
    carry = jnp.zeros_like(top)
    # Extract chunks from least significant (shift 0) upward, balancing each
    # into [-B/2, B/2]: d in [0, 2^B]; if d >= B/2 emit d - B and carry 1.
    # The final carry out of the most-significant chunk wraps mod q.
    for i in range(levels):
        chunk = (top >> U32(i * B)) & mask
        d = chunk + carry
        carry = ((d + half) >> U32(B)).astype(U32)
        d_signed = d.astype(jnp.int32) - (carry << U32(B)).astype(jnp.int32)
        digits.append(d_signed)
    digits.reverse()  # most-significant digit first
    return jnp.stack(digits, axis=0)


def balanced_bytes(a: T64) -> jax.Array:
    """T64 -> (8, *shape) int8 balanced byte digits (device-side).

    a === sum_u b_u * 256^u (mod 2^64), b_u in [-128, 128); the top carry
    wraps.  Used to run levelled integer ops (conv, pool) on ciphertext
    limbs as exact small-operand matmuls.
    """
    out = []
    # lo limb: unsigned; extract 4 balanced bytes tracking the uint32 wrap
    # of (r - b) when b < 0 (b < 0 implies the true diff >= 129, so a
    # wrapped diff is identifiable by diff < 256).
    r32 = a.lo
    for _ in range(4):
        low = (r32 & U32(255)).astype(jnp.int32)
        b = ((low + 128) & 255) - 128
        out.append(b.astype(jnp.int8))
        diff = r32 - b.astype(U32)
        wrapped = (b < 0) & (diff < U32(256))
        r32 = (diff >> U32(8)) + jnp.where(wrapped, U32(1 << 24), U32(0))
    # after 4 bytes the remainder is the carry into the hi limb (0 or 1)
    h = (a.hi + r32).astype(jnp.int32)
    # hi limb (+ carry): signed arithmetic; the final carry wraps mod 2^64
    for _ in range(4):
        b = ((h + 128) & 255) - 128
        out.append(b.astype(jnp.int8))
        h = (h - b) >> 8
    return jnp.stack(out, axis=0)


def from_balanced_bytes(bb: jax.Array) -> T64:
    """Inverse of :func:`balanced_bytes` (for tests)."""
    acc = zeros(bb.shape[1:])
    for u in range(8):
        acc = add(acc, from_i32_shifted(bb[u].astype(jnp.int32), 8 * u))
    return acc


def recompose(digits, base_log: int) -> T64:
    """Inverse of :func:`decompose` (for testing): sum_i d_i * 2^(64-i*B)."""
    levels = digits.shape[0]
    acc = zeros(digits.shape[1:])
    for i in range(levels):
        term = from_i32_shifted(digits[i], 64 - (i + 1) * base_log)
        acc = add(acc, term)
    return acc
