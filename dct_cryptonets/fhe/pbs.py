"""Batched TFHE server-side operations: blind rotate, sample extract,
keyswitch, programmable bootstrapping.

This re-designs the native TFHE execution engine the reference drives
through Concrete (``q_module.forward(..., fhe='execute')``, reference
homomorphic_eval.py:70): instead of one multithreaded CPU PBS at a time,
*batches* of LWE ciphertexts are bootstrapped together so the per-CMUX
external products become large exact int8 matrix products.

Exact arithmetic strategy (mod 2^64, no FFT error):
  * ciphertexts are (hi, lo) uint32 limb pairs (``fhe.torus``);
  * the external product contracts small gadget digits against BSK
    polynomials.  Digits are split into signed bytes, BSK coefficients into
    8 unsigned byte limbs over the *doubled, pre-negated* polynomial
    b~ = [b, -b] of length 2N (so the negacyclic wrap becomes a plain index
    ``(c - t) mod 2N`` with no sign bookkeeping);
  * each (digit-byte u, key-limb v) pair is an int8 x int8 -> int32
    matmul; byte products are exact and the int32 accumulator cannot
    overflow for the supported sizes; buckets s = u + v are recombined into
    limb pairs with shifts (u + v >= 8 wraps out of the 64-bit word and is
    dropped — exactly mod 2^64);
  * an optional ``drop_limbs`` knob omits low key limbs whose contribution
    is below the noise floor (throughput mode; keeps decrypted messages
    intact w.h.p. per the noise model).

All entry points are jit-compatible and shape-static.
"""
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import torus as T
from .params import TFHEParams
from .keys import ServerKeyMaterial

I8 = jnp.int8
I32 = jnp.int32
U32 = jnp.uint32


# ---------------------------------------------------------------------------
# device key preprocessing


class DeviceServerKeys(NamedTuple):
    """Server key material in byte-limb layout."""
    # (n, (k+1)*l, k+1, 2N, 8) int8: balanced byte limbs of [bsk, -bsk]
    bsk_bytes: jax.Array
    # (kN * l_ks, n+1, 8) int8: balanced byte limbs of the keyswitch LWEs
    ksk_bytes: jax.Array


def u64_to_balanced_bytes(x: np.ndarray) -> np.ndarray:
    """uint64 array -> (..., 8) int8 *balanced* byte digits.

    x === sum_u b_u * 256^u (mod 2^64) with b_u in [-128, 128); the carry out
    of the top byte wraps mod 2^64.  Balanced digits keep every matmul
    operand in int8 with no offset-correction terms.
    """
    r = x.astype(np.int64)  # two's complement reinterpretation
    out = np.empty((*x.shape, 8), np.int8)
    for u in range(8):
        b = ((r + 128) & 255) - 128
        out[..., u] = b.astype(np.int8)
        r = (r - b) >> 8
    return out


def preprocess_server_keys(sk: ServerKeyMaterial) -> DeviceServerKeys:
    with np.errstate(over="ignore"):
        doubled = np.concatenate([sk.bsk, -sk.bsk], axis=-1)  # (..., 2N)
    bsk_bytes = u64_to_balanced_bytes(doubled)
    kN, l_ks, n1 = sk.ksk.shape
    ksk_bytes = u64_to_balanced_bytes(sk.ksk.reshape(kN * l_ks, n1))
    return DeviceServerKeys(jnp.asarray(bsk_bytes), jnp.asarray(ksk_bytes))


# ---------------------------------------------------------------------------
# byte splitting of small signed integers


def signed_byte_split(d: jax.Array, nbytes: int) -> jax.Array:
    """int32 -> (nbytes, ...) int8 balanced byte digits: d = sum b_u * 256^u,
    b_u in [-128, 128)."""
    out = []
    r = d
    for _ in range(nbytes):
        b = ((r + 128) & 255) - 128
        out.append(b.astype(I8))
        r = (r - b) >> 8
    return jnp.stack(out, axis=0)


def _combine_buckets(buckets: list[jax.Array], shifts: list[int]) -> T.T64:
    """Sum of int32 buckets placed at byte offsets (mod 2^64) -> T64."""
    acc = T.zeros(buckets[0].shape)
    for b, s in zip(buckets, shifts):
        acc = T.add(acc, T.from_i32_shifted(b, 8 * s))
    return acc


# ---------------------------------------------------------------------------
# negacyclic rotations (per-sample amounts)


def static_negacyclic_roll(p: T.T64, r: int) -> T.T64:
    """X^r * p for a STATIC r in [0, 2N): slice+concat roll with the
    negacyclic sign flip — no gathers, elementwise work only."""
    N = p.hi.shape[-1]
    r = r % (2 * N)
    upper = r >= N           # X^N = -1: global negation
    r = r % N

    def roll(x):
        if r == 0:
            return x
        a, b = jnp.split(x, [N - r], axis=-1)
        return jnp.concatenate([b, a], axis=-1)

    out = T.T64(roll(p.hi), roll(p.lo))
    negd = T.neg(out)
    if r == 0:
        return negd if upper else out
    # wrapped positions c < r picked p[N - r + c] -> one extra sign flip
    flip = jnp.arange(N) < r
    if upper:
        flip = ~flip
    return T.select(flip, negd, out)


def negacyclic_rotate_bits(p: T.T64, amount: jax.Array) -> T.T64:
    """X^amount * p with per-sample amounts, via log2(2N) conditional
    *static* rolls (amount bit decomposition).  No gathers: each bit is
    one slice/concatenate roll and a select.

    p: (M, ..., N) T64; amount: (M,) integers in [0, 2N).
    """
    N = p.hi.shape[-1]
    bits = int(np.log2(2 * N))
    amount = jnp.asarray(amount).astype(jnp.uint32)
    cond_shape = (amount.shape[0],) + (1,) * (p.hi.ndim - 1)
    out = p
    for b in range(bits):
        rolled = static_negacyclic_roll(out, 1 << b)
        cond = ((amount >> b) & 1).astype(bool).reshape(cond_shape)
        out = T.select(cond, rolled, out)
    return out


# ---------------------------------------------------------------------------
# external product (batched, byte-limb matmuls)


def _digit_bytes_count(base_log: int) -> int:
    # digits lie in [-B/2, B/2]; bytes needed for base_log bits (signed)
    return max(1, (base_log + 7) // 8)


def toeplitz_from_doubled(dbl: jax.Array) -> jax.Array:
    """(..., 2N) -> (..., N, N) negacyclic matrices T[t, c] = dbl[(c-t) % 2N].

    Built with the tile/reshape trick (no gathers): for a length-(2N+1)
    vector z with z[x] = dbl[x] (x < N) and z[y] = dbl[y-1] (y > N),
    tiling z N times and reshaping to (N, 2N) yields rows shifted by one —
    exactly the Toeplitz diagonals.  Pure broadcasts/copies, ~memory-speed.
    """
    *lead, twoN = dbl.shape
    N = twoN // 2
    Q = twoN + 1
    zpad = jnp.zeros((*lead, 1), dbl.dtype)
    z = jnp.concatenate([dbl[..., :N], zpad, dbl[..., N:]], axis=-1)  # (.., Q)
    tiled = jnp.broadcast_to(z[..., None, :], (*lead, N, Q))
    flat = tiled.reshape(*lead, N * Q)[..., :N * (Q - 1)]
    return flat.reshape(*lead, N, Q - 1)[..., :N]


def external_product_step(diff: T.T64, bsk_bytes_i: jax.Array,
                          params_tuple, drop_limbs: int, cross: int = 0):
    """One external product: GGSW_i x (M, k+1, N) GLWE -> (M, k+1, N) GLWE.

    The negacyclic polynomial products are matrix products against the
    Toeplitz matrices of the GGSW byte limbs: gadget-digit bytes (M, rows*N)
    times one (rows*N, (k+1)*N) matrix per kept key limb, each an exact
    int8 x int8 -> int32 GEMM.  Products land in int32 buckets by byte
    scale s = u + v and recombine into limb pairs mod 2^64.

    diff: batched GLWE (M, k+1, N) T64
    bsk_bytes_i: ((k+1)*l, k+1, 2N, 8) int8 balanced bytes of [b, -b].
    """
    (blog, levels, k, N) = params_tuple
    M = diff.hi.shape[0]
    rows = (k + 1) * levels
    dbytes = _digit_bytes_count(blog)

    digits = T.decompose(diff, blog, levels)     # (levels, M, k+1, N)
    dB = signed_byte_split(digits, dbytes)       # (dbytes, levels, M, k+1, N)
    # contraction layout (dbytes, M, rows*N), row-major r = j*levels + lev
    dB = jnp.transpose(dB, (0, 2, 3, 1, 4)).reshape(dbytes, M, rows * N)

    # Toeplitz blocks: (rows, k+1, L, N, N) -> (L, rows*N, (k+1)*N)
    kept = bsk_bytes_i[..., drop_limbs:]          # (rows, k+1, 2N, L)
    kept = jnp.moveaxis(kept, -1, 2)              # (rows, k+1, L, 2N)
    blocks = toeplitz_from_doubled(kept)          # (rows, k+1, L, N, N)
    mats = jnp.transpose(blocks, (2, 0, 3, 1, 4)).reshape(
        8 - drop_limbs, rows * N, (k + 1) * N)

    buckets: dict[int, jax.Array] = {}
    for u in range(dbytes):
        for vi in range(8 - drop_limbs):
            s = u + vi + drop_limbs
            if s >= 8 or u + vi < cross:
                continue
            prod = jax.lax.dot(dB[u], mats[vi], preferred_element_type=I32)
            buckets[s] = buckets.get(s, 0) + prod  # (M, (k+1)*N)

    shifts = sorted(buckets)
    acc = _combine_buckets([buckets[s] for s in shifts], shifts)
    return T.T64(acc.hi.reshape(M, k + 1, N), acc.lo.reshape(M, k + 1, N))


def cmux_accumulate(acc: T.T64, a_i: jax.Array, bsk_bytes_i: jax.Array,
                    params_tuple, drop_limbs: int, cross: int = 0) -> T.T64:
    """acc <- acc + GGSW_i x (X^{a_i} acc - acc)  (the CMUX of blind rotate)."""
    rot = negacyclic_rotate_bits(acc, a_i)
    diff = T.sub(rot, acc)
    ext = external_product_step(diff, bsk_bytes_i, params_tuple, drop_limbs,
                                cross)
    return T.add(acc, ext)
# ---------------------------------------------------------------------------
# blind rotate + sample extract + keyswitch


def mod_switch(ct_t64: T.T64, N: int) -> jax.Array:
    """Torus -> Z_{2N} with rounding: (..., ) uint32 in [0, 2N)."""
    bits = int(np.log2(2 * N))
    return T.round_shift_right(ct_t64, 64 - bits) & U32(2 * N - 1)


def blind_rotate(test_poly: T.T64, ct_a: jax.Array, ct_b: jax.Array,
                 bsk_bytes: jax.Array, params: TFHEParams,
                 drop_limbs: int = 0, cross: int = 0) -> T.T64:
    """Batched blind rotate.

    test_poly: (M, N) T64 — per-sample lookup polynomials
    ct_a: (M, n) uint32 mod-switched mask;  ct_b: (M,) uint32 mod-switched body
    cross: skip external-product byte pairs with digit-byte + key-limb
           index < cross (the "cross skip"; noise modeled by
           NoiseModel.var_drop_cross, chosen per layer by the circuit audit)
    Returns GLWE accumulators (M, k+1, N) T64 whose constant phase
    coefficient is test_poly evaluated at the encrypted index.
    """
    k, N = params.glwe_dim, params.poly_size
    M = test_poly.hi.shape[0]
    pt = (params.pbs_base_log, params.pbs_levels, k, N)

    # acc init: mask = 0, body = X^{-b} * v
    body = negacyclic_rotate_bits(test_poly, (U32(2 * N) - ct_b) % U32(2 * N))
    zero_mask = T.zeros((M, k, N))
    acc = T.T64(jnp.concatenate([zero_mask.hi, body.hi[:, None]], axis=1),
                jnp.concatenate([zero_mask.lo, body.lo[:, None]], axis=1))

    def step(carry, inputs):
        a_col, bsk_i = inputs
        return cmux_accumulate(carry, a_col, bsk_i, pt, drop_limbs,
                               cross), None

    a_cols = jnp.transpose(ct_a, (1, 0))             # (n, M)
    acc, _ = jax.lax.scan(step, acc, (a_cols, bsk_bytes))
    return acc


def sample_extract(acc: T.T64, params: TFHEParams) -> T.T64:
    """Extract the constant coefficient as a big-LWE ciphertext.

    acc: (M, k+1, N) -> returns (M, kN + 1) T64 under the flattened GLWE key.
    a_ext[j*N + i] = mask[j, 0] if i == 0 else -mask[j, N - i];
    b_ext = body[0].
    """
    k, N = params.glwe_dim, params.poly_size
    M = acc.hi.shape[0]
    mask = T.T64(acc.hi[:, :k], acc.lo[:, :k])       # (M, k, N)
    idx = (-jnp.arange(N, dtype=jnp.int32)) % N      # [0, N-1, N-2, ...]
    g_hi = jnp.take(mask.hi, idx, axis=-1)
    g_lo = jnp.take(mask.lo, idx, axis=-1)
    g = T.T64(g_hi, g_lo)
    negate = jnp.arange(N) != 0
    a_ext = T.select(negate, T.neg(g), g)            # (M, k, N)
    a_flat = T.T64(a_ext.hi.reshape(M, k * N), a_ext.lo.reshape(M, k * N))
    b = T.T64(acc.hi[:, k, 0:1], acc.lo[:, k, 0:1])
    return T.T64(jnp.concatenate([a_flat.hi, b.hi], axis=1),
                 jnp.concatenate([a_flat.lo, b.lo], axis=1))


def key_switch(big_ct: T.T64, ksk_bytes: jax.Array,
               params: TFHEParams) -> T.T64:
    """Switch (M, kN+1) big-LWE down to (M, n+1) small-LWE (the KS stage of
    the standard PBS; dims/base from ``params``)."""
    return lwe_key_switch(big_ct, ksk_bytes, params.ks_base_log,
                          params.ks_levels)


def lwe_key_switch(ct: T.T64, ksk_bytes: jax.Array, blog: int,
                   levels: int, ks_drop: int = 0) -> T.T64:
    """Generic LWE->LWE keyswitch: (M, d_src+1) -> (M, d_dst+1).

    out = (0, .., 0, b) - sum_{i, level} d_{i,level} * KSK[i, level]
    computed as byte-limb int8 matmuls against the flattened KSK.
    ksk_bytes: (d_src * levels, d_dst + 1, 8) int8 balanced byte limbs.
    Dimensions are inferred from the key shape, so the same code serves the
    PBS keyswitch and the cross-key hops of exact rounding / partitions.

    ks_drop: skip the low ``ks_drop`` byte limbs of the key (truncated-KSK
    throughput mode — each dropped limb cuts one (M, d_src*l) x
    (d_src*l, d_dst+1) matmul and its key stream; added noise per
    NoiseModel.var_ks_drop, chosen by the circuit audit).
    """
    kN = ksk_bytes.shape[0] // levels      # d_src
    n = ksk_bytes.shape[1] - 1             # d_dst
    M = ct.hi.shape[0]
    assert ct.hi.shape[1] == kN + 1, (ct.hi.shape, kN)
    a = T.T64(ct.hi[:, :kN], ct.lo[:, :kN])
    b = T.T64(ct.hi[:, kN:], ct.lo[:, kN:])

    digits = T.decompose(a, blog, levels)            # (levels, M, kN)
    digits = jnp.transpose(digits, (1, 2, 0)).reshape(M, kN * levels)
    dbytes = _digit_bytes_count(blog)
    dB = signed_byte_split(digits, dbytes)           # (dbytes, M, kN*l)
    assert ksk_bytes.shape[0] == kN * levels

    buckets: dict[int, jax.Array] = {}
    for u in range(dbytes):
        for v in range(ks_drop, 8):
            s = u + v
            if s >= 8:
                continue
            prod = jax.lax.dot(dB[u], ksk_bytes[:, :, v],
                               preferred_element_type=I32)
            buckets[s] = buckets.get(s, 0) + prod
    shifts = sorted(buckets)
    acc = _combine_buckets([buckets[s] for s in shifts], shifts)  # (M, n+1)

    out = T.neg(acc)
    # add body into the last column
    body_col = T.add(T.T64(out.hi[:, n:], out.lo[:, n:]), b)
    return T.T64(jnp.concatenate([out.hi[:, :n], body_col.hi], axis=1),
                 jnp.concatenate([out.lo[:, :n], body_col.lo], axis=1))


# ---------------------------------------------------------------------------
# full PBS


def make_test_polys(tables: jax.Array, params: TFHEParams,
                    out_delta_log2: int) -> T.T64:
    """Encode per-sample integer tables as lookup polynomials.

    tables: (M, 2^r) int32 — TLU outputs for inputs 0..2^r-1 (the input is
    assumed encoded with one padding bit, Delta_in = 2^(64-r-1)).
    Returns (M, N) T64 with window j holding tables[..] * 2^out_delta_log2,
    pre-rotated by half a window so the PBS rounds to the nearest index.
    """
    N = params.poly_size
    M, tsize = tables.shape
    assert tsize <= N, (
        f"TLU table of {tsize} entries exceeds the parameter set's "
        f"polynomial size N={N} — the circuit's rounded precision must "
        f"satisfy 2^r <= N (pick a larger preset)")
    reps = N // tsize
    # window-expand: (M, N) int32
    expanded = jnp.repeat(tables, reps, axis=1)
    vals = T.from_i32_shifted(expanded, out_delta_log2)
    # pre-rotate by +reps/2 (half window) to center windows on indices:
    # p <- X^{-(reps/2)} p  implemented as a static roll by 2N - reps/2.
    return static_negacyclic_roll(vals, 2 * N - reps // 2)


@partial(jax.jit, static_argnames=("params", "out_delta_log2", "drop_limbs",
                                   "cross"))
def bootstrap(ct: T.T64, tables: jax.Array, dsk: DeviceServerKeys,
              params: TFHEParams, out_delta_log2: int,
              drop_limbs: int = 0, cross: int = 0) -> T.T64:
    """Batched programmable bootstrap, Concrete order: KS -> MS -> BR -> SE.

    Activations live as big-LWE (dim kN) so that levelled dot products
    amplify only the (small) blind-rotate output noise, never the keyswitch
    noise — the keyswitch to the small key happens right before each PBS
    and its noise goes straight into the modulus switch.

    ct: (M, kN+1) T64 big-LWE ciphertexts encoding index u with
        Delta_in = 2^(64 - r - 1) where tables.shape[1] == 2^r.
    tables: (M, 2^r) int32.
    Returns (M, kN+1) T64 big-LWE encrypting tables[u] * 2^out_delta_log2.
    """
    n, N = params.lwe_dim, params.poly_size
    small = key_switch(ct, dsk.ksk_bytes, params)    # (M, n+1)
    ms = mod_switch(small, N)                        # (M, n+1) uint32
    test = make_test_polys(tables, params, out_delta_log2)
    acc = blind_rotate(test, ms[:, :n], ms[:, n], dsk.bsk_bytes, params,
                       drop_limbs, cross)
    return sample_extract(acc, params)


@partial(jax.jit, static_argnames=("params", "out_delta_log2", "drop_limbs",
                                   "cross", "pbs_batch"))
def bootstrap_chunked(ct: T.T64, tables: jax.Array, dsk: DeviceServerKeys,
                      params: TFHEParams, out_delta_log2: int,
                      pbs_batch: int, drop_limbs: int = 0, cross: int = 0) -> T.T64:
    """:func:`bootstrap` over M = k * pbs_batch sites as ONE jitted scan.

    A TLU layer's site batch is bootstrapped in pbs_batch chunks; issuing
    each chunk as its own jitted call costs one host->device dispatch per
    chunk.  Scanning the chunks inside one jit collapses a layer's main
    pass to a single dispatch.  The caller pads M to a pbs_batch multiple.
    """
    M, n1 = ct.hi.shape
    assert M % pbs_batch == 0, (M, pbs_batch)
    nch = M // pbs_batch
    if nch == 1:
        return bootstrap(ct, tables, dsk, params, out_delta_log2,
                         drop_limbs, cross)
    chi = ct.hi.reshape(nch, pbs_batch, n1)
    clo = ct.lo.reshape(nch, pbs_batch, n1)
    tb = tables.reshape(nch, pbs_batch, tables.shape[1])

    def body(_, x):
        hi, lo, t = x
        r = bootstrap(T.T64(hi, lo), t, dsk, params, out_delta_log2,
                      drop_limbs, cross)
        return None, (r.hi, r.lo)

    _, (ohi, olo) = jax.lax.scan(body, None, (chi, clo, tb))
    return T.T64(ohi.reshape(M, -1), olo.reshape(M, -1))


# ---------------------------------------------------------------------------
# exact rounding: LSB extraction on an auxiliary parameter set
#
# Concrete's default ``rounding_threshold_bits`` semantics ("exact" method)
# clears the accumulator's dropped low bits with auxiliary bootstraps before
# the main table lookup, so the PBS phase sits exactly on window centers and
# simulate == execute bit-exactly at production noise (the reference's
# compile path defaults to this mode; homomorphic_eval.py:276-285).  The
# approximate mode (no clearing) matches Concrete's faster
# ``Exactness.APPROXIMATE`` option.
#
# Extraction is per-bit, LSB-first (the TFHE sign-bootstrap construction —
# multi-bit chunks are impossible in one PBS because the bit just above a
# chunk lands exactly on the padding position and cannot wrap away, flipping
# the negacyclic sign).  After clearing bits [0, lo), shifting the
# ciphertext left by 2^(n_in - lo) puts bit lo at the torus sign position:
# bits above wrap away mod 2^64 and bits below are already cleared, so the
# phase is b * 2^63 (+ shifted noise).  Adding a quarter-torus offset
# centers both cases 2^62 away from the half-torus boundaries, and a
# blind rotate over the CONSTANT test polynomial -h reads -h for b=0 and
# +h for b=1 (pure negacyclic sign); +h levelled then gives b * 2h, which
# keyswitches back to the main big key and subtracts off.


class DeviceAuxKeys(NamedTuple):
    """Extraction key set in byte-limb layout (see keys.py)."""
    bsk_bytes: jax.Array       # (n_aux, (k+1)l, k+1, 2N_aux, 8) int8
    ksk_fwd_bytes: jax.Array   # (kN_main * l_ks_aux, n_aux + 1, 8) int8
    ksk_back_bytes: jax.Array  # (kN_aux * back_levels, kN_main + 1, 8) int8


def preprocess_aux_keys(ak) -> DeviceAuxKeys:
    """AuxServerKeyMaterial -> device byte-limb layout."""
    with np.errstate(over="ignore"):
        doubled = np.concatenate([ak.bsk, -ak.bsk], axis=-1)
    bsk_bytes = u64_to_balanced_bytes(doubled)
    s, l, d = ak.ksk_fwd.shape
    fwd = u64_to_balanced_bytes(ak.ksk_fwd.reshape(s * l, d))
    s2, l2, d2 = ak.ksk_back.shape
    back = u64_to_balanced_bytes(ak.ksk_back.reshape(s2 * l2, d2))
    return DeviceAuxKeys(jnp.asarray(bsk_bytes), jnp.asarray(fwd),
                         jnp.asarray(back))


@partial(jax.jit, static_argnames=("aux_params", "n_in", "shift",
                                   "back_base_log", "back_levels",
                                   "drop_limbs", "cross", "fwd_ks_drop",
                                   "back_ks_drop", "keep_low",
                                   "aux_batch"))
def clear_low_bits_chunked(ct: T.T64, aux_keys: DeviceAuxKeys,
                           aux_params: TFHEParams, n_in: int, shift: int,
                           back_base_log: int, back_levels: int,
                           aux_batch: int, drop_limbs: int = 0,
                           cross: int = 0, fwd_ks_drop: int = 0,
                           back_ks_drop: int = 0, keep_low: int = 0) -> T.T64:
    """:func:`clear_low_bits` over M = k * aux_batch sites as ONE jitted
    scan (same dispatch-collapsing rationale as :func:`bootstrap_chunked`;
    the caller pads M to an aux_batch multiple)."""
    M, n1 = ct.hi.shape
    assert M % aux_batch == 0, (M, aux_batch)
    nch = M // aux_batch
    if nch == 1:
        return clear_low_bits(ct, aux_keys, aux_params, n_in, shift,
                              back_base_log, back_levels, drop_limbs,
                              cross, fwd_ks_drop, back_ks_drop, keep_low)
    chi = ct.hi.reshape(nch, aux_batch, n1)
    clo = ct.lo.reshape(nch, aux_batch, n1)

    def body(_, x):
        hi, lo = x
        r = clear_low_bits(T.T64(hi, lo), aux_keys, aux_params, n_in,
                           shift, back_base_log, back_levels, drop_limbs,
                           cross, fwd_ks_drop, back_ks_drop, keep_low)
        return None, (r.hi, r.lo)

    _, (ohi, olo) = jax.lax.scan(body, None, (chi, clo))
    return T.T64(ohi.reshape(M, -1), olo.reshape(M, -1))


@partial(jax.jit, static_argnames=("aux_params", "n_in", "shift",
                                   "back_base_log", "back_levels",
                                   "drop_limbs", "cross", "fwd_ks_drop",
                                   "back_ks_drop", "keep_low"))
def clear_low_bits(ct: T.T64, aux_keys: DeviceAuxKeys,
                   aux_params: TFHEParams, n_in: int, shift: int,
                   back_base_log: int, back_levels: int,
                   drop_limbs: int = 0, cross: int = 0,
                   fwd_ks_drop: int = 0, back_ks_drop: int = 0,
                   keep_low: int = 0) -> T.T64:
    """Subtract bits [keep_low, shift) of an n_in-bit-encoded accumulator.

    ct: (M, kN_main+1) big-LWE whose phase encodes v * 2^(63 - n_in),
    v >= 0 (the runtime recenters before clearing).  Returns a ciphertext
    of (v - (v mod 2^shift - v mod 2^keep_low)) * 2^(63 - n_in) (+ the
    original noise and small extraction/keyswitch noise).  With the
    round-half-up constant added beforehand, the caller's main PBS then
    reads exactly the simulator's rounded index whenever no audited
    decision slips.  Costs ``shift - keep_low`` aux sign bootstraps per
    sample.

    ``keep_low`` (the audit's partial-clearing depth) leaves the lowest
    bits uncleared: they sit below the main mod-switch noise floor, so
    clearing them is wasted work.  Each remaining bit's shift-up then
    carries the uncleared junk j in [0, 2^keep_low) at 2^(63 - lo); the
    sign offset is re-centered per bit to
    ``2^62 - (2^keep_low - 1) * 2^(62 - lo)`` which keeps a symmetric
    margin of at least 2^(62 - keep_low) around both half-torus
    boundaries (the audit checks it against the aux KS+MS noise).
    """
    n_aux, N_aux = aux_params.lwe_dim, aux_params.poly_size
    M = ct.hi.shape[0]
    w = ct
    for lo in range(keep_low, shift):
        # bit lo -> sign position 63; bits above wrap away, bits in
        # [keep_low, lo) are cleared, bits below keep_low are centered by
        # the reduced offset.
        t = T.shift_left(w, n_in - lo)
        off = T.from_i32_shifted(jnp.ones((M, 1), jnp.int32), 62)
        if keep_low > 0:
            off = T.sub(off, T.from_i32_shifted(
                jnp.full((M, 1), (1 << keep_low) - 1, jnp.int32), 62 - lo))
        body = T.add(T.T64(t.hi[:, -1:], t.lo[:, -1:]), off)
        t = T.T64(jnp.concatenate([t.hi[:, :-1], body.hi], axis=1),
                  jnp.concatenate([t.lo[:, :-1], body.lo], axis=1))
        small = lwe_key_switch(t, aux_keys.ksk_fwd_bytes,
                               aux_params.ks_base_log, aux_params.ks_levels,
                               fwd_ks_drop)
        ms = mod_switch(small, N_aux)
        # constant test poly -h with h = Delta_out / 2 = 2^(62 - n_in + lo):
        # BR constant coeff = -h (b=0) / +h (b=1); +h makes it b * 2h.
        h_log2 = 62 - n_in + lo
        neg_h = T.neg(T.from_i32_shifted(
            jnp.ones((M, N_aux), jnp.int32), h_log2))
        acc = blind_rotate(neg_h, ms[:, :n_aux], ms[:, n_aux],
                           aux_keys.bsk_bytes, aux_params, drop_limbs,
                           cross)
        bit_big = sample_extract(acc, aux_params)     # aux big key
        hb = T.add(T.T64(bit_big.hi[:, -1:], bit_big.lo[:, -1:]),
                   T.from_i32_shifted(jnp.ones((M, 1), jnp.int32), h_log2))
        bit_big = T.T64(jnp.concatenate([bit_big.hi[:, :-1], hb.hi], axis=1),
                        jnp.concatenate([bit_big.lo[:, :-1], hb.lo], axis=1))
        bit_main = lwe_key_switch(bit_big, aux_keys.ksk_back_bytes,
                                  back_base_log, back_levels, back_ks_drop)
        w = T.sub(w, bit_main)
    return w
