"""Client-side TFHE key material: generation, encryption, decryption.

Host-side numpy (uint64) — key generation and the client encrypt/decrypt
boundary are not throughput-critical; the server-side hot path lives in
``fhe.pbs``.  Replaces the role of Concrete's ``fhe_circuit.keygen()`` /
encrypt/decrypt (reference homomorphic_eval.py:314-316 and the hidden
client half of ``q_module.forward``).

Conventions (CGGI/TFHE standard):
  * q = 2^64; binary secret keys.
  * LWE ciphertext = (a_0..a_{n-1}, b) with b = <a, s> + m + e  (all mod q).
  * GLWE ciphertext = (A_0..A_{k-1}, B) polynomials in Z_q[X]/(X^N + 1),
    B = sum_j A_j * S_j + M + E.
  * GGSW(m) rows: for j in 0..k, level in 1..l:
      GLWE(0) + m * q/B^level placed on component j (negated for j < k).
  * Bootstrapping key: GGSW encryptions of each small-LWE key bit under the
    GLWE key.  Keyswitch key: LWE encryptions of each big-LWE key bit times
    the gadget, under the small key.
"""
import hashlib
import secrets
from dataclasses import dataclass

import numpy as np

from .params import TFHEParams

U64 = np.uint64


class Csprng:
    """Cryptographic PRNG (SHAKE-256 in counter mode) for key material.

    Secret keys, encryption masks, and noise must not come from numpy's
    PCG64 (a statistical generator whose state is recoverable from outputs);
    Concrete/TFHE-rs use a CSPRNG for all of them.  SHAKE-256 keyed with a
    256-bit secret gives cryptographic-strength expansion while keeping
    generation *deterministic for a fixed seed* — needed for reproducible
    tests, key caching, and the same-seed -> same-ciphertext determinism
    contract (SURVEY §5).  ``seed=None`` draws a fresh OS-entropy key
    (production mode).

    Implements the small slice of the ``numpy.random.Generator`` API the
    key paths use (``integers`` over power-of-two spans, ``normal``), so it
    is a drop-in replacement at every call site.
    """

    def __init__(self, seed: int | bytes | None = None):
        if seed is None:
            self._key = secrets.token_bytes(32)
        elif isinstance(seed, (bytes, bytearray)):
            self._key = hashlib.sha256(bytes(seed)).digest()
        else:
            self._key = hashlib.sha256(
                b"dct-cryptonets/csprng/v1:"
                + int(seed).to_bytes(16, "little", signed=True)).digest()
        self._ctr = 0

    def _raw(self, nbytes: int) -> bytes:
        h = hashlib.shake_256(self._key + self._ctr.to_bytes(16, "little"))
        self._ctr += 1
        return h.digest(nbytes)

    def _u64(self, count: int) -> np.ndarray:
        return np.frombuffer(self._raw(8 * max(count, 1)), np.uint64).copy()

    @staticmethod
    def _shape(size) -> tuple:
        if size is None:
            return ()
        return tuple(size) if isinstance(size, (tuple, list)) else (int(size),)

    def integers(self, low, high, size=None, dtype=np.int64) -> np.ndarray:
        """Uniform ints in [low, high) — span must be a power of two (the
        only spans the key paths use), masked from raw 64-bit words so the
        distribution is exactly uniform."""
        span = int(high) - int(low)
        if span <= 0 or (span & (span - 1)) != 0:
            # a hard error, not an assert: under ``python -O`` an assert is
            # stripped and a non-power-of-two span would silently return
            # BIASED values for key/mask material (fails open on a
            # security invariant)
            raise ValueError(
                f"Csprng.integers requires a power-of-two span, got {span}")
        shape = self._shape(size)
        n = int(np.prod(shape)) if shape else 1
        v = (self._u64(n) & U64(span - 1)).reshape(shape)
        out = v.astype(np.int64) + int(low)
        return out.astype(dtype) if dtype is not np.int64 else out

    def normal(self, loc: float, scale: float, size=None) -> np.ndarray:
        """Gaussian via Box-Muller over CSPRNG uniforms (float64)."""
        shape = self._shape(size)
        n = int(np.prod(shape)) if shape else 1
        m = n + (n & 1)
        # 53-bit mantissa uniforms in (0, 1]
        u = (self._u64(2 * m) >> np.uint64(11)).astype(np.float64)
        u = (u + 1.0) * 2.0 ** -53
        r = np.sqrt(-2.0 * np.log(u[:m]))
        th = 2.0 * np.pi * u[m:]
        z = np.concatenate([r * np.cos(th), r * np.sin(th)])[:n]
        return (loc + scale * z).reshape(shape)


def _negacyclic_polymul_u64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact negacyclic product of two uint64 coefficient vectors (mod 2^64).

    O(N^2) host reference used only in keygen/tests.
    """
    N = a.shape[-1]
    res = np.zeros(N, U64)
    with np.errstate(over="ignore"):
        for t in range(N):
            at = a[t]
            if at == 0:
                continue
            prod = at * b  # wraps mod 2^64
            res[t:] += prod[: N - t]
            if t:
                res[: t] -= prod[N - t:]  # X^N = -1 wrap-around
    return res


def _poly_mul_accum(acc: np.ndarray, a: np.ndarray, b: np.ndarray):
    with np.errstate(over="ignore"):
        acc += _negacyclic_polymul_u64(a, b)


@dataclass
class ClientKeys:
    params: TFHEParams
    lwe_key: np.ndarray        # (n,) uint64 in {0,1} — small key
    glwe_key: np.ndarray       # (k, N) uint64 in {0,1}

    @property
    def big_lwe_key(self) -> np.ndarray:
        """Key of LWE samples extracted from GLWE accumulators: the GLWE key
        coefficients flattened in (j, coeff) order."""
        return self.glwe_key.reshape(-1)


@dataclass
class ServerKeyMaterial:
    """Raw uint64 server keys (pre device preprocessing).

    bsk: (n, (k+1)*l, k+1, N)  GGSW rows per small-key bit
    ksk: (kN, l_ks, n+1)       keyswitch LWEs, last column is the body
    """
    params: TFHEParams
    bsk: np.ndarray
    ksk: np.ndarray


def keygen(params: TFHEParams, seed: int | None = 0) -> ClientKeys:
    """Generate client secret keys (CSPRNG; ``seed=None`` = OS entropy)."""
    rng = Csprng(seed)
    lwe_key = rng.integers(0, 2, params.lwe_dim).astype(U64)
    glwe_key = rng.integers(0, 2, (params.glwe_dim, params.poly_size)).astype(U64)
    return ClientKeys(params, lwe_key, glwe_key)


def _gaussian_u64(rng, sigma_log2: float, shape) -> np.ndarray:
    std = 2.0 ** sigma_log2
    e = rng.normal(0.0, std, shape)
    return np.round(e).astype(np.int64).astype(U64)


def encrypt_lwe(ck: ClientKeys, mu: np.ndarray, rng,
                key: np.ndarray | None = None,
                noise_log2: float | None = None) -> np.ndarray:
    """Encrypt torus values mu (uint64, any shape) -> (*shape, n+1) uint64."""
    key = ck.lwe_key if key is None else key
    n = key.shape[0]
    mu = np.asarray(mu, U64)
    a = rng.integers(0, 1 << 63, (*mu.shape, n), dtype=np.int64).astype(U64)
    a = (a << U64(1)) | rng.integers(0, 2, (*mu.shape, n)).astype(U64)
    e = _gaussian_u64(
        rng, ck.params.lwe_noise_log2 if noise_log2 is None else noise_log2,
        mu.shape)
    with np.errstate(over="ignore"):
        b = (a * key).sum(axis=-1, dtype=U64) + mu + e
    return np.concatenate([a, b[..., None]], axis=-1)


def decrypt_lwe(ck: ClientKeys, ct: np.ndarray,
                key: np.ndarray | None = None) -> np.ndarray:
    """Raw phase b - <a, s> (uint64); caller decodes/rounds."""
    key = ck.lwe_key if key is None else key
    with np.errstate(over="ignore"):
        return ct[..., -1] - (ct[..., :-1] * key).sum(axis=-1, dtype=U64)


def encrypt_glwe_zero(ck: ClientKeys, rng) -> np.ndarray:
    """Fresh GLWE(0): returns (k+1, N) uint64 (mask rows then body)."""
    p = ck.params
    k, N = p.glwe_dim, p.poly_size
    a = rng.integers(0, 1 << 63, (k, N), dtype=np.int64).astype(U64)
    a = (a << U64(1)) | rng.integers(0, 2, (k, N)).astype(U64)
    body = _gaussian_u64(rng, p.glwe_noise_log2, N)
    for j in range(k):
        _poly_mul_accum(body, a[j], ck.glwe_key[j])
    return np.concatenate([a, body[None]], axis=0)


def encrypt_ggsw_bit(ck: ClientKeys, bit: int, rng) -> np.ndarray:
    """GGSW encryption of a bit: ((k+1)*l, k+1, N) uint64.

    Row (j, level) = GLWE(0) + bit * q/B^(level+1) on component j, with the
    mask components carrying -s_j * m * gadget implicitly via the added
    constant on A_j (standard construction: add m*g to the j-th column).
    """
    p = ck.params
    k, N, l, blog = p.glwe_dim, p.poly_size, p.pbs_levels, p.pbs_base_log
    rows = []
    with np.errstate(over="ignore"):
        for j in range(k + 1):
            for level in range(1, l + 1):
                row = encrypt_glwe_zero(ck, rng)
                gadget = U64(1) << U64(64 - blog * level)
                row[j, 0] += U64(bit) * gadget
                rows.append(row)
    return np.stack(rows, axis=0)


def make_bootstrap_key(ck: ClientKeys, rng) -> np.ndarray:
    """(n, (k+1)*l, k+1, N) uint64 — GGSW of each small-key bit."""
    return np.stack(
        [encrypt_ggsw_bit(ck, int(b), rng) for b in ck.lwe_key], axis=0)


def make_keyswitch_key(ck: ClientKeys, rng) -> np.ndarray:
    """(kN, l_ks, n+1) uint64: LWE_small(big_key_i * q/B^(level+1))."""
    p = ck.params
    big = ck.big_lwe_key
    l, blog = p.ks_levels, p.ks_base_log
    with np.errstate(over="ignore"):
        gadgets = np.array([U64(1) << U64(64 - blog * (lev + 1))
                            for lev in range(l)], U64)
        mus = big[:, None] * gadgets[None, :]          # (kN, l)
    return encrypt_lwe(ck, mus, rng)


def make_server_keys(ck: ClientKeys, seed: int | None = 1) -> ServerKeyMaterial:
    rng = Csprng(seed)
    bsk = make_bootstrap_key(ck, rng)
    ksk = make_keyswitch_key(ck, rng)
    return ServerKeyMaterial(ck.params, bsk, ksk)


# ---------------------------------------------------------------------------
# cross-key material (exact rounding / multi-partition circuits)


def make_lwe_to_lwe_keyswitch_key(src_key: np.ndarray, dst_key: np.ndarray,
                                  base_log: int, levels: int,
                                  noise_log2: float, ck: ClientKeys,
                                  rng) -> np.ndarray:
    """Generic LWE->LWE keyswitch key: (len(src), levels, len(dst)+1) uint64.

    LWE_dst(src_key_i * q / B^(level+1)) — lets the server re-encrypt an LWE
    sample under ``src_key`` as one under ``dst_key``.  Used for the
    cross-parameter-set hops of exact rounding (main big key -> extraction
    small key, extraction big key -> main big key); Concrete inserts the
    same keys between circuit partitions.
    """
    l, blog = levels, base_log
    with np.errstate(over="ignore"):
        gadgets = np.array([U64(1) << U64(64 - blog * (lev + 1))
                            for lev in range(l)], U64)
        mus = src_key[:, None] * gadgets[None, :]      # (src_dim, l)
    return encrypt_lwe(ck, mus, rng, key=dst_key, noise_log2=noise_log2)


@dataclass
class AuxServerKeyMaterial:
    """Server keys for the LSB-extraction PBS of exact rounding.

    The extraction PBS runs on a cheap auxiliary parameter set (smaller N):
      input big-LWE (main big key) --ksk_fwd--> aux small key --BR (bsk)-->
      aux big key --ksk_back--> main big key.

    bsk:      (n_aux, (k+1)*l, k+1, N_aux) GGSW rows of the aux small key
              under the aux GLWE key
    ksk_fwd:  (kN_main, l_ks_aux, n_aux+1)  main big key -> aux small key
    ksk_back: (kN_aux, back_levels, kN_main+1)  aux big key -> main big key
    """
    params: "TFHEParams"         # aux parameter set
    back_base_log: int
    back_levels: int
    bsk: np.ndarray
    ksk_fwd: np.ndarray
    ksk_back: np.ndarray


def make_aux_server_keys(main_ck: ClientKeys, aux_params: TFHEParams,
                         seed: int | None = 2, back_base_log: int = 4,
                         back_levels: int = 6) -> AuxServerKeyMaterial:
    """Generate the auxiliary key set for exact-rounding LSB extraction."""
    rng = Csprng(seed)
    aux_ck = keygen(aux_params,
                    seed=None if seed is None else seed + 10_000)
    bsk = make_bootstrap_key(aux_ck, rng)
    ksk_fwd = make_lwe_to_lwe_keyswitch_key(
        main_ck.big_lwe_key, aux_ck.lwe_key,
        aux_params.ks_base_log, aux_params.ks_levels,
        aux_params.lwe_noise_log2, aux_ck, rng)
    ksk_back = make_lwe_to_lwe_keyswitch_key(
        aux_ck.big_lwe_key, main_ck.big_lwe_key,
        back_base_log, back_levels,
        main_ck.params.glwe_noise_log2, main_ck, rng)
    return AuxServerKeyMaterial(aux_params, back_base_log, back_levels,
                                bsk, ksk_fwd, ksk_back)


def decrypt_glwe(ck: ClientKeys, ct: np.ndarray) -> np.ndarray:
    """Phase polynomial of a GLWE ciphertext (k+1, N) -> (N,)."""
    body = ct[-1].copy()
    with np.errstate(over="ignore"):
        for j in range(ck.params.glwe_dim):
            body -= _negacyclic_polymul_u64(ct[j], ck.glwe_key[j])
    return body
