"""Plain numpy reference of the batched blind rotate.

Written independently of ``fhe.pbs``: uint64 torus arithmetic, the signed
gadget decomposition, and each negacyclic polynomial product as an explicit
gather of the doubled key table (no Toeplitz tiling trick, no GEMM).  It
keeps the engine's byte-level semantics — digit byte u times key limb v at
byte scale u + v, pairs with u + v + drop >= 8 wrap out of the word, pairs
with u + v < cross are skipped — so it matches bit-for-bit at every
(drop_limbs, cross) setting.
"""
import numpy as np

U64 = np.uint64


def _rotate(p, amount):
    """X^amount * p for (M, ..., N) uint64 and per-sample amounts (M,)."""
    N = p.shape[-1]
    c = np.arange(N)
    out = np.empty_like(p)
    with np.errstate(over="ignore"):
        for m, a in enumerate(np.asarray(amount, np.int64)):
            idx = (c - a) % (2 * N)
            neg = idx >= N
            v = p[m][..., idx % N]
            out[m] = np.where(neg, U64(0) - v, v)
    return out


def _decompose(a, base_log, levels):
    """(M, ...) uint64 -> (levels, M, ...) int64 digits in [-B/2, B/2]."""
    total = base_log * levels
    with np.errstate(over="ignore"):
        top = (a + (U64(1) << U64(63 - total))) >> U64(64 - total)
    top = top.astype(np.int64)
    B = 1 << base_log
    digits, carry = [], 0
    for i in range(levels):
        d = ((top >> (i * base_log)) & (B - 1)) + carry
        carry = (d + B // 2) >> base_log
        digits.append(d - (carry << base_log))
    return np.stack(digits[::-1])


def _bytes(d, nbytes):
    out, r = [], d
    for _ in range(nbytes):
        b = ((r + 128) & 255) - 128
        out.append(b)
        r = (r - b) >> 8
    return out


def external_product_ref(diff, bsk_bytes_i, base_log, levels, drop, cross):
    """diff: (M, k+1, N) uint64; bsk_bytes_i: ((k+1)l, k+1, 2N, 8) int8."""
    M, k1, N = diff.shape
    digits = _decompose(diff, base_log, levels)          # (l, M, k+1, N)
    nbytes = max(1, (base_log + 7) // 8)
    dB = _bytes(digits, nbytes)
    t = np.arange(N)
    tbl_idx = (t[None, :] - t[:, None]) % (2 * N)        # [t, c] = (c-t)%2N
    out = np.zeros((M, k1, N), U64)
    with np.errstate(over="ignore"):
        for u in range(nbytes):
            for v in range(drop, 8):
                if u + v >= 8 or u + v - drop < cross:
                    continue
                acc = np.zeros((M, k1, N), np.int64)
                for j in range(k1):
                    for lev in range(levels):
                        row = j * levels + lev
                        for jo in range(k1):
                            T = bsk_bytes_i[row, jo, :, v].astype(
                                np.int64)[tbl_idx]       # (N, N)
                            acc[:, jo] += dB[u][lev, :, j] @ T
                out += acc.astype(U64) << U64(8 * (u + v))
    return out


def blind_rotate_ref(test_poly, ct_a, ct_b, bsk_bytes, params, drop=0,
                     cross=0):
    """test_poly: (M, N) uint64; ct_a: (M, n); ct_b: (M,) in [0, 2N).
    Returns the (M, k+1, N) uint64 GLWE accumulators."""
    k, N = params.glwe_dim, params.poly_size
    M = test_poly.shape[0]
    acc = np.zeros((M, k + 1, N), U64)
    acc[:, k] = _rotate(test_poly, (2 * N - np.asarray(ct_b)) % (2 * N))
    with np.errstate(over="ignore"):
        for i in range(params.lwe_dim):
            diff = _rotate(acc, np.asarray(ct_a)[:, i]) - acc
            acc = acc + external_product_ref(
                diff, bsk_bytes[i], params.pbs_base_log, params.pbs_levels,
                drop, cross)
    return acc
