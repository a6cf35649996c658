"""Encrypted execution of compiled circuits.

The framework's equivalent of Concrete's compiled ``q_module`` — the object
the reference drives as ``q_module.forward(data, fhe=...)`` after
``fhe_circuit.keygen()`` (reference homomorphic_eval.py:60-86, 314-316).

Server-side levelled ops run on ciphertext *limb bytes*: a T64 LWE tensor is
split into 8 balanced int8 byte planes, the integer conv runs on all planes
as one exact int8 GEMM with int32 accumulation, and planes recombine with
shifts mod 2^64.  TLUs batch all sites of a layer into one `pbs.bootstrap`
call so the blind rotate's CMUX products are large GEMMs.

Client-side encrypt/decrypt stays in numpy (``fhe.keys``).
"""
import math
import time
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from . import torus as T
from .circuit import (AddScaled, AddScaledPC, Circuit, Conv, Output, PoolSum,
                      QuantIn, Rescale, Tlu, Window, simulate)
from .keys import (ClientKeys, decrypt_lwe, encrypt_lwe, keygen,
                   make_aux_server_keys, make_server_keys)
from .params import (ExactRoundingConfig, TFHEParams,
                     default_exact_rounding, params_for_precision)
from .pbs import (DeviceAuxKeys, DeviceServerKeys, bootstrap, clear_low_bits,
                  preprocess_aux_keys, preprocess_server_keys)

U64 = np.uint64
I32 = jnp.int32


def _conv_limbs(ct: T.T64, w: np.ndarray, stride: int, padding: int) -> T.T64:
    """Integer conv of a ciphertext tensor by plaintext integer weights.

    ct: (B, n1, H, W, C) T64 (n1 = LWE size, treated as batch)
    w:  (kh, kw, C, Cout) integer weights

    The 8 balanced byte planes of the limbs fold into the rows of ONE
    im2col matrix, and the weights split into balanced int8 bytes (one
    plane when |w| <= 127, as in every QAT/PTQ config of the reference
    table).  Each (limb byte, weight byte) pair is then an exact
    int8 x int8 -> int32 GEMM, recombined with shifts mod 2^64.  The
    contraction is zero-padded to a multiple of 4: XLA:GPU computed an
    int8 dot with K=3 wrongly on the H100 (PERF.md, PR 1).
    """
    B, n1, H, W, C = ct.hi.shape
    kh, kw, _, co = w.shape
    oh = (H + 2 * padding - kh) // stride + 1
    ow = (W + 2 * padding - kw) // stride + 1
    bb = T.balanced_bytes(ct).reshape(8 * B * n1, H, W, C)
    bb = jnp.pad(bb, ((0, 0), (padding, padding), (padding, padding), (0, 0)))
    cols = [bb[:, dy:dy + (oh - 1) * stride + 1:stride,
               dx:dx + (ow - 1) * stride + 1:stride]
            for dy in range(kh) for dx in range(kw)]
    K = kh * kw * C
    pad = (-K) % 4
    patches = jnp.pad(jnp.concatenate(cols, axis=-1).reshape(-1, K),
                      ((0, 0), (0, pad)))

    r = np.pad(np.asarray(w, np.int64).reshape(K, co), ((0, pad), (0, 0)))
    planes = []
    while True:
        b = ((r + 128) & 255) - 128
        planes.append(b.astype(np.int8))
        r = (r - b) >> 8
        if not r.any():
            break
    nw = len(planes)
    y = jax.lax.dot(patches, jnp.asarray(np.concatenate(planes, axis=1)),
                    preferred_element_type=I32)
    y = y.reshape(8, B * n1, oh, ow, nw, co)
    acc = T.zeros((B * n1, oh, ow, co))
    for u in range(8):
        for v in range(min(nw, 8 - u)):
            acc = T.add(acc, T.from_i32_shifted(y[u, ..., v, :], 8 * (u + v)))
    return T.T64(acc.hi.reshape(B, n1, oh, ow, co),
                 acc.lo.reshape(B, n1, oh, ow, co))


def _pool_limbs(ct: T.T64, k: int) -> T.T64:
    """Window-sum pooling — conv with an identity-channel ones kernel is
    wasteful; sum windows directly per limb pair with wrapping adds."""
    B, n1, H, W, C = ct.hi.shape
    oh, ow = H // k, W // k
    hi = ct.hi[:, :, :oh * k, :ow * k].reshape(B, n1, oh, k, ow, k, C)
    lo = ct.lo[:, :, :oh * k, :ow * k].reshape(B, n1, oh, k, ow, k, C)
    acc = T.zeros((B, n1, oh, ow, C))
    for i in range(k):
        for j in range(k):
            acc = T.add(acc, T.T64(hi[:, :, :, i, :, j], lo[:, :, :, i, :, j]))
    return acc


@dataclass
class CompiledModule:
    """Mirror of Concrete's q_module API surface used by the reference."""
    circuit: Circuit
    params: TFHEParams
    client_keys: ClientKeys | None = None
    device_keys: DeviceServerKeys | None = None
    # bootstrap chunk sizes: main lattice and exact-rounding extraction
    pbs_batch: int = 2048
    aux_batch: int = 4096
    stats: dict = field(default_factory=dict)
    # Concrete's rounding exactness: "exact" (its default — LSB-extraction
    # PBS clears the dropped accumulator bits, execute == simulate
    # bit-exactly at production noise) or "approximate" (faster: rounded
    # TLUs may slip +-1 window with probability set by the dropped-LSB
    # phase; Concrete's Exactness.APPROXIMATE).
    rounding_method: str = "exact"
    exact_cfg: ExactRoundingConfig | None = None
    aux_keys: DeviceAuxKeys | None = None
    # low BSK byte limbs skipped in extraction blind rotates; None = pick
    # the largest noise-safe value from the NoiseModel at keygen
    aux_drop_limbs: int | None = None
    # cross skip for extraction blind rotates (pbs.py ``cross``)
    aux_cross: int = 0
    # truncated-KSK limb drops for the extraction keyswitch hops
    aux_fwd_ks_drop: int = 0
    aux_back_ks_drop: int = 0
    # "none": no limbs dropped anywhere (bit-exact vs the simulator while
    #   ciphertext noise stays below half an accumulator LSB — the unit-test
    #   contract); "audit": per-TLU-layer limb drops chosen by the circuit
    #   noise audit under the p_error contract (production throughput mode,
    #   Concrete's actual semantics — its optimizer proves p_error, not
    #   bit-exactness).
    drop_policy: str = "none"
    p_error: float = 0.01
    audit = None

    # -- reference-compatible helpers ------------------------------------
    def maximum_integer_bit_width(self) -> int:
        return self.circuit.max_bit_width()

    def _needs_extraction(self) -> bool:
        return (self.rounding_method == "exact"
                and any(isinstance(op, Tlu) and op.spec.shift > 0
                        for op in self.circuit.ops))

    def run_audit(self):
        """Run (and cache) the circuit noise audit for this module —
        per-TLU p_error verification + safe per-layer limb drops
        (fhe/noise_audit.py; Concrete's optimizer role)."""
        if self.audit is None:
            from .noise_audit import audit_circuit
            if self.exact_cfg is None and self._needs_extraction():
                self.exact_cfg = default_exact_rounding(self.params)
            self.audit = audit_circuit(
                self.circuit, self.params, p_error=self.p_error,
                rounding_method=self.rounding_method,
                exact_cfg=self.exact_cfg)
        return self.audit

    def keygen(self, seed: int = 0):
        t = time.time()
        self.client_keys = keygen(self.params, seed)
        sk = make_server_keys(self.client_keys, seed + 1)
        self.device_keys = preprocess_server_keys(sk)
        if self._needs_extraction():
            if self.exact_cfg is None:
                self.exact_cfg = default_exact_rounding(self.params)
            ak = make_aux_server_keys(
                self.client_keys, self.exact_cfg.aux, seed=seed + 2,
                back_base_log=self.exact_cfg.back_base_log,
                back_levels=self.exact_cfg.back_levels)
            self.aux_keys = preprocess_aux_keys(ak)
            if self.aux_drop_limbs is None:
                # under the audit policy, the extraction drop comes from
                # the circuit noise audit (the extracted-bit ciphertexts
                # are subtracted into the accumulator, so their dropped-
                # limb noise is checked against every decision margin);
                # otherwise keep the bit-exact contract (no drops).
                if self.drop_policy == "audit":
                    audit = self.run_audit()
                    self.aux_drop_limbs = audit.aux_drop_limbs
                    self.aux_cross = audit.aux_cross
                    self.aux_fwd_ks_drop = audit.aux_fwd_ks_drop
                    self.aux_back_ks_drop = audit.aux_back_ks_drop
                else:
                    self.aux_drop_limbs = 0
        self.stats["keygen_time"] = time.time() - t

    # -- client side ------------------------------------------------------
    def encrypt(self, x: np.ndarray, rng=None) -> T.T64:
        """Quantize + encrypt a float input batch (B, H, W, C).

        ``rng``: a :class:`~.keys.Csprng` (default: fresh OS entropy —
        encryption masks are key material; pass ``Csprng(seed)`` for the
        deterministic same-seed -> same-ciphertext contract)."""
        from .keys import Csprng
        rng = rng or Csprng(None)
        qin = self.circuit.ops[0]
        assert isinstance(qin, QuantIn)
        qmax = 2 ** (qin.bits - 1) - 1
        qmin = -(2 ** (qin.bits - 1))
        x_int = np.clip(np.round(np.asarray(x) / qin.scale), qmin, qmax)
        delta_log2 = 63 - qin.n
        with np.errstate(over="ignore"):
            mu = (x_int.astype(np.int64).astype(U64) << U64(delta_log2))
        # activations are big-LWE (under the flattened GLWE key): levelled
        # ops amplify only this fresh noise + BR noise, never KS noise
        ct = encrypt_lwe(self.client_keys, mu, rng,
                         key=self.client_keys.big_lwe_key,
                         noise_log2=self.params.glwe_noise_log2)
        # (B,H,W,C,kN+1)
        B, H, W, C, n1 = ct.shape
        ct = np.moveaxis(ct, -1, 1)                   # (B, n1, H, W, C)
        return T.from_u64(ct)

    def decrypt_feats(self, ct: T.T64) -> np.ndarray:
        """Decrypt output ciphertexts -> float features (B, F)."""
        out_op = self.circuit.ops[-1]
        assert isinstance(out_op, Output)
        n_y = self.circuit.n_budget[out_op.x]
        shift = 63 - n_y
        cts = T.to_u64(ct)                            # (B, n1, h, w, C)
        B, n1 = cts.shape[:2]
        flat = np.moveaxis(cts, 1, -1).reshape(B, -1, n1)
        phase = decrypt_lwe(self.client_keys, flat,
                            key=self.client_keys.big_lwe_key)
        with np.errstate(over="ignore"):
            v = ((phase + (U64(1) << U64(shift - 1))) >> U64(shift))
        mod = 1 << (n_y + 1)
        v = (v & U64(mod - 1)).astype(np.int64)
        v = np.where(v >= mod // 2, v - mod, v)
        return v.astype(np.float32) * out_op.scale

    def _decrypt_wire(self, ct: T.T64, wire) -> np.ndarray:
        """Decrypt an intermediate ciphertext wire -> signed int values
        (B, H, W, C), decoded at the wire's accumulator budget.  Client-key
        debug path used by the realized-slip audit (``check_ref``)."""
        n = self.circuit.n_budget[wire]
        shift = 63 - n
        cts = T.to_u64(ct)                            # (B, n1, H, W, C)
        flat = np.moveaxis(cts, 1, -1)                # (B, H, W, C, n1)
        phase = decrypt_lwe(self.client_keys, flat,
                            key=self.client_keys.big_lwe_key)
        with np.errstate(over="ignore"):
            v = ((phase + (U64(1) << U64(shift - 1))) >> U64(shift))
        mod = 1 << (n + 1)
        v = (v & U64(mod - 1)).astype(np.int64)
        return np.where(v >= mod // 2, v - mod, v)

    # -- server side -------------------------------------------------------
    def run_encrypted(self, ct_in: T.T64, drop_limbs: int | None = None,
                      check_ref: dict | None = None) -> T.T64:
        """Server-side evaluation, with per-stage wall-clock accounting
        (the reference only reports end-to-end FHE latency; we also track
        levelled vs PBS time and a PBS/s counter — SURVEY §5).

        ``drop_limbs``: explicit global blind-rotate limb drop; None means
        policy-driven (0 under "none", per-TLU audited values under
        "audit").

        ``check_ref``: optional clear wire environment from
        ``circuit.simulate(..., return_env=True)``.  Debug/audit-validation
        mode (needs client keys): after every TLU the output is decrypted
        and compared element-wise against its clear value — the REALIZED
        per-TLU slip count vs the noise audit's per-PBS p_error bound.
        Mismatched positions are re-aligned by a plaintext constant add on
        the ciphertext body (no noise change), so every TLU measures its
        own slip rate against correct inputs with the genuine accumulated
        noise rather than compounding the first divergence.  Results land
        in ``stats["tlu_slips"] / ["tlu_sites"] / ["tlu_slip_detail"]``."""
        if drop_limbs is None and self.drop_policy == "audit":
            self.run_audit()
        env = {}
        # wire liveness: a (B, kN+1, H, W, C) ciphertext tensor is ~100s of
        # MB; free each wire after its last consumer so device memory holds
        # only the live wires beside the server keys.
        last_use: dict = {}
        for i, op in enumerate(self.circuit.ops):
            for attr in ("x", "a", "b"):
                w = getattr(op, attr, None)
                if w is not None:
                    last_use[w] = i
        pbs_count = 0
        slips = sites = 0
        slip_detail = []
        t0 = time.time()
        t_lvl = t_pbs = t_audit = 0.0
        for i, op in enumerate(self.circuit.ops):
            t_op = time.time()
            if isinstance(op, QuantIn):
                env[op.out] = ct_in
            elif isinstance(op, Conv):
                env[op.out] = _conv_limbs(env[op.x], op.w, op.stride,
                                          op.padding)
                jax.block_until_ready(env[op.out].hi)
                t_lvl += time.time() - t_op
            elif isinstance(op, PoolSum):
                env[op.out] = _pool_limbs(env[op.x], op.k)
                t_lvl += time.time() - t_op
            elif isinstance(op, Window):
                # zero padding = trivial all-zero ciphertexts (encrypt 0
                # with zero mask/noise), then a strided slice
                x = env[op.x]
                p, s = op.pad, op.stride
                pads = ((0, 0), (0, 0), (p, p), (p, p), (0, 0))
                hi = jnp.pad(x.hi, pads)
                lo = jnp.pad(x.lo, pads)
                sl = (slice(None), slice(None),
                      slice(op.dy, op.dy + op.out_h * s, s),
                      slice(op.dx, op.dx + op.out_w * s, s), slice(None))
                env[op.out] = T.T64(hi[sl], lo[sl])
                t_lvl += time.time() - t_op
            elif isinstance(op, AddScaled):
                a = T.scalar_mul(env[op.a], op.ca * (1 << op.ja))
                b = T.scalar_mul(env[op.b], op.cb * (1 << op.jb))
                env[op.out] = T.add(a, b)
                t_lvl += time.time() - t_op
            elif isinstance(op, AddScaledPC):
                # per-channel multipliers broadcast over the trailing
                # channel axis of the (B, n1, H, W, C) ciphertext layout
                ma = jnp.asarray(op.ca, jnp.int32) * (1 << op.ja)
                mb = jnp.asarray(op.cb, jnp.int32) * (1 << op.jb)
                env[op.out] = T.add(T.scalar_mul(env[op.a], ma),
                                    T.scalar_mul(env[op.b], mb))
                t_lvl += time.time() - t_op
            elif isinstance(op, Rescale):
                # phase-only re-encode to a finer budget (circuit.Rescale)
                x = env[op.x]
                env[op.out] = T.T64(*((x.hi, x.lo) if op.j == 0 else
                                      T.shift_left(x, op.j)))
                t_lvl += time.time() - t_op
            elif isinstance(op, Tlu):
                env[op.out] = self._run_tlu(env[op.x], op, drop_limbs)
                jax.block_until_ready(env[op.out].hi)
                pbs_count += int(np.prod(env[op.x].hi.shape[:1] +
                                         env[op.x].hi.shape[2:]))
                t_pbs += time.time() - t_op
                if check_ref is not None:
                    # the audit's decrypt/compare/realign is instrumentation,
                    # not inference work: accumulate it separately and
                    # subtract from execute_time so an audited run's
                    # s/image stat matches a clean execute run
                    t_ck = time.time()
                    got = self._decrypt_wire(env[op.out], op.out)
                    ref = np.asarray(check_ref[op.out], np.int64)
                    diff = ref - got
                    n_bad = int(np.count_nonzero(diff))
                    slips += n_bad
                    sites += got.size
                    # magnitude split: |diff| <= 1 output step is the
                    # noise-slip signature the p_error contract prices; a
                    # larger jump means a gross event (e.g. accumulator
                    # outside calibrated range wrapping the PBS phase)
                    n_gross = int(np.count_nonzero(np.abs(diff) > 1))
                    max_abs = int(np.abs(diff).max()) if n_bad else 0
                    slip_detail.append((op.out, n_bad, got.size, n_gross,
                                        max_abs))
                    print(f"# slip-audit {op.out}: {n_bad}/{got.size} "
                          f"(gross>{1}: {n_gross}, max|d| {max_abs}; "
                          f"cum {slips}/{sites}, {pbs_count} PBS, "
                          f"{time.time()-t0:.0f}s)", flush=True)
                    if n_bad:
                        # re-align slipped values with a plaintext add on
                        # the body (noise untouched) so downstream TLUs
                        # measure their own slip rate, not this one's echo
                        shift = 63 - self.circuit.n_budget[op.out]
                        cts = T.to_u64(env[op.out])
                        with np.errstate(over="ignore"):
                            cts[:, -1] += diff.astype(U64) << U64(shift)
                        env[op.out] = T.from_u64(cts)
                    t_audit += time.time() - t_ck
            elif isinstance(op, Output):
                result = env[op.x]
            else:
                raise TypeError(op)
            for attr in ("x", "a", "b"):
                w = getattr(op, attr, None)
                if w is not None and last_use.get(w) == i:
                    env.pop(w, None)     # last consumer done: free the wire
        dt = time.time() - t0
        self.stats.update({
            "pbs_per_sample": self.circuit.num_pbs,
            "pbs_executed": pbs_count,
            # audit (check_ref) decrypt/compare time is instrumentation
            # overhead, excluded so the end-to-end s/image stat of an
            # audited run is comparable to a clean execute run
            "execute_time": dt - t_audit,
            "levelled_time": t_lvl,
            "pbs_time": t_pbs,
            "pbs_per_sec": pbs_count / t_pbs if t_pbs > 0 else None,
        })
        if check_ref is not None:
            self.stats.update({"tlu_slips": slips, "tlu_sites": sites,
                               "tlu_slip_detail": slip_detail,
                               "audit_time": t_audit})
        return result

    def _run_tlu(self, ct: T.T64, op: Tlu, drop_limbs: int | None) -> T.T64:
        cross = 0
        if drop_limbs is None:
            if self.drop_policy == "audit" and self.audit:
                drop_limbs = self.audit.drop_for(op.x)
                cross = self.audit.cross_for(op.x)
            else:
                drop_limbs = 0
        spec = op.spec
        B, n1, H, W, C = ct.hi.shape
        M = B * H * W * C
        # sites-first layout: (B,H,W,C,n1)
        hi = jnp.moveaxis(ct.hi, 1, -1).reshape(M, n1)
        lo = jnp.moveaxis(ct.lo, 1, -1).reshape(M, n1)
        flat = T.T64(hi, lo)
        n_in = spec.in_bits + spec.shift
        exact = self.rounding_method == "exact" and spec.shift > 0
        # Body constant: recenter (+2^(n_in-1) * Delta == +2^62) plus the
        # rounding offset.
        #   approximate: a half-LSB dither (+Delta/2 == 2^(62-n_in)) turns
        #   the PBS's round-to-nearest-window into the simulator's
        #   floor((acc + 2^(shift-1)) / 2^shift) — exact whenever ciphertext
        #   noise stays below half an accumulator LSB, else the dropped-LSB
        #   phase may slip the window by +-1 (Concrete APPROXIMATE mode).
        #   exact: the full round-half-up constant (+2^(shift-1) * Delta ==
        #   +2^(62-in_bits)), after which clear_low_bits subtracts the low
        #   `shift` bits so the phase sits exactly on window centers
        #   (Concrete's default EXACT mode).
        const = T.from_i32_shifted(jnp.ones((M, 1), jnp.int32), 62)
        if spec.shift > 0:
            # rounding offset — only when bits are actually dropped.  With
            # shift == 0 the phase already sits on a window center and the
            # half-LSB dither would park it exactly ON the window boundary,
            # where the nearest-window read becomes a noise-sign coin flip.
            off_log2 = (62 - spec.in_bits) if exact else (62 - n_in)
            const = T.add(const, T.from_i32_shifted(
                jnp.ones((M, 1), jnp.int32), off_log2))
        # partial clearing (audit's keep_low): the lowest `keep` dropped
        # bits stay uncleared and ride through as a bounded offset; a
        # 2^(keep-1)*Delta centering constant re-centers that junk on the
        # window center.  The centering is applied AFTER clear_low_bits
        # (below, per chunk): subtracting it before clearing would borrow
        # across the cleared bit field whenever the kept low bits are
        # < 2^(keep-1), shifting the extracted field so the main PBS reads
        # one window low — a deterministic misread for a 2^(keep-1)/2^shift
        # fraction of accumulator values.
        keep = 0
        if exact and self.drop_policy == "audit" and self.audit is not None:
            keep = min(self.audit.keep_for(op.x), spec.shift)
        body = T.add(T.T64(flat.hi[:, -1:], flat.lo[:, -1:]), const)
        flat = T.T64(jnp.concatenate([flat.hi[:, :-1], body.hi], axis=1),
                     jnp.concatenate([flat.lo[:, :-1], body.lo], axis=1))

        tables = jnp.asarray(op.table, jnp.int32)     # (C, 2^r)
        site_tables = jnp.broadcast_to(tables[None, None, None],
                                       (B, H, W, C, tables.shape[1]))
        site_tables = site_tables.reshape(M, tables.shape[1])

        out_delta = 63 - spec.out_n
        cfg = self.exact_cfg
        # pass 1: exact-rounding clears, in AUX-sized chunks scanned inside
        # ONE jitted call (pbs.clear_low_bits_chunked — one host dispatch
        # per layer instead of one per chunk).  The two passes chunk
        # independently (aux_batch, pbs_batch).  Remainders pad with
        # trivial zero ciphertexts.
        if exact and spec.shift > keep:
            assert self.aux_keys is not None, "keygen() first"
            from .pbs import clear_low_bits_chunked
            kw = dict(drop_limbs=self.aux_drop_limbs, cross=self.aux_cross,
                      fwd_ks_drop=self.aux_fwd_ks_drop,
                      back_ks_drop=self.aux_back_ks_drop, keep_low=keep)
            if M <= self.aux_batch:
                flat = clear_low_bits(flat, self.aux_keys, cfg.aux, n_in,
                                      spec.shift, cfg.back_base_log,
                                      cfg.back_levels, **kw)
            else:
                pad = (-M) % self.aux_batch
                zp = ((0, pad), (0, 0))
                ch = clear_low_bits_chunked(
                    T.T64(jnp.pad(flat.hi, zp), jnp.pad(flat.lo, zp)),
                    self.aux_keys, cfg.aux, n_in, spec.shift,
                    cfg.back_base_log, cfg.back_levels, self.aux_batch,
                    **kw)
                flat = T.T64(ch.hi[:M], ch.lo[:M])
            self.stats["aux_pbs_executed"] = (
                self.stats.get("aux_pbs_executed", 0)
                + (spec.shift - keep) * M)
        if keep > 0:
            # center the uncleared junk on the window center — after the
            # clearing, so the subtraction cannot borrow into the (now
            # cleared) extracted bit field.  At keep == shift no clearing
            # ran and this cancels the round-half-up constant: the whole
            # dropped range rides as a centered offset.
            cc = T.from_i32_shifted(jnp.ones((M, 1), jnp.int32),
                                    62 - n_in + keep)
            cb = T.sub(T.T64(flat.hi[:, -1:], flat.lo[:, -1:]), cc)
            flat = T.T64(jnp.concatenate([flat.hi[:, :-1], cb.hi], axis=1),
                         jnp.concatenate([flat.lo[:, :-1], cb.lo], axis=1))
        # pass 2: the main bootstraps, pbs_batch chunks scanned inside one
        # jitted call (pbs.bootstrap_chunked); zero-ciphertext padding
        if M <= self.pbs_batch:
            out = bootstrap(flat, site_tables, self.device_keys,
                            self.params, out_delta, drop_limbs, cross)
        else:
            from .pbs import bootstrap_chunked
            pad = (-M) % self.pbs_batch
            zp = ((0, pad), (0, 0))
            res = bootstrap_chunked(
                T.T64(jnp.pad(flat.hi, zp), jnp.pad(flat.lo, zp)),
                jnp.pad(site_tables, zp), self.device_keys, self.params,
                out_delta, self.pbs_batch, drop_limbs, cross)
            out = T.T64(res.hi[:M], res.lo[:M])
        n_big = self.params.big_lwe_dim + 1
        hi = jnp.moveaxis(out.hi.reshape(B, H, W, C, n_big), -1, 1)
        lo = jnp.moveaxis(out.lo.reshape(B, H, W, C, n_big), -1, 1)
        return T.T64(hi, lo)

    # -- multi-chip --------------------------------------------------------
    def shard_over(self, mesh):
        """Place the module's server key material on a device mesh.

        Server-side parallelism is ciphertext-batch data parallelism
        (every image's ciphertexts are independent — SURVEY §2.3): keys
        replicate (a one-time broadcast), ciphertext batches shard on
        the leading axis.  After this call, ``forward(..., fhe='execute',
        mesh=mesh)`` runs the encrypted evaluation across the mesh; XLA
        propagates the batch sharding through every levelled op and the
        batched bootstraps, with no collectives on the hot path.
        """
        from ..parallel.mesh import replicate
        from .pbs import DeviceAuxKeys, DeviceServerKeys
        assert self.device_keys is not None, "call keygen() first"
        self.device_keys = DeviceServerKeys(
            *replicate(mesh, list(self.device_keys)))
        if self.aux_keys is not None:
            self.aux_keys = DeviceAuxKeys(*replicate(mesh, list(self.aux_keys)))
        return self

    # -- the reference-style entry point ----------------------------------
    def forward(self, x: np.ndarray, fhe: str = "simulate",
                drop_limbs: int | None = None, mesh=None,
                enc_rng=None, check_ref: bool = False) -> np.ndarray:
        """x: float input batch (B, H, W, C) -> float features (B, F).

        fhe='simulate': bit-exact integer simulation (fast, clear).
        fhe='execute':  encrypt -> encrypted eval -> decrypt.
        mesh: optional jax.sharding.Mesh — shards the ciphertext batch
        across devices (keys must be placed first via ``shard_over``).
        enc_rng: optional :class:`~.keys.Csprng` for the encryption masks
        (default fresh OS entropy; pass a seeded one for the deterministic
        same-seed -> same-ciphertext contract).
        check_ref (execute only): run the clear simulator alongside and
        decrypt-compare every TLU output — the realized-slip audit
        (``run_encrypted(check_ref=...)``); results in ``stats``.
        """
        if fhe == "simulate":
            return np.asarray(simulate(self.circuit, jnp.asarray(x)))
        if fhe == "execute":
            assert self.client_keys is not None, "call keygen() first"
            n = len(x)
            if mesh is not None:
                # pad a remainder batch up to a mesh-size multiple (repeat
                # the last sample): shard_batch's NamedSharding device_put
                # rejects non-divisible leading axes, which would crash the
                # final partial batch of a multi-hour sweep
                m = int(np.prod(mesh.devices.shape))
                if n % m:
                    x = np.concatenate(
                        [x, np.repeat(x[-1:], m - n % m, axis=0)], axis=0)
            env_ref = None
            if check_ref:
                _, env_ref = simulate(self.circuit, jnp.asarray(x),
                                      return_env=True)
                env_ref = {k: np.asarray(v) for k, v in env_ref.items()}
            ct = self.encrypt(x, rng=enc_rng)
            if mesh is not None:
                from ..parallel.mesh import shard_batch
                ct = T.T64(*shard_batch(mesh, list(ct)))
            out = self.run_encrypted(ct, drop_limbs, check_ref=env_ref)
            return self.decrypt_feats(out)[:n]
        raise ValueError(f"unknown fhe mode {fhe!r}")


def compile_qat_model(params, state, spec, *, n_bits: int = 5,
                      rounding_threshold_bits=6,
                      calib_absmax: float | None = None,
                      calib_data=None,
                      tfhe_params: TFHEParams | None = None,
                      pbs_batch: int = 2048,
                      drop_policy: str = "none",
                      p_error: float = 0.01,
                      range_margin: float = 1.0,
                      residual_mode: str = "fused") -> CompiledModule:
    """End-to-end compile: QAT model -> circuit -> executable module.

    Mirrors ``compile_brevitas_qat_model(model.module.feature, calib_data,
    rounding_threshold_bits, n_bits, p_error)`` (reference
    homomorphic_eval.py:276-285); ``calib_data`` switches accumulator bit
    budgets to calibration-derived ranges as Concrete does.

    ``rounding_threshold_bits`` accepts an int (method defaults to "exact",
    like Concrete) or a dict ``{"n_bits": r, "method": "exact" |
    "approximate"}`` — the same surface Concrete-ML exposes.
    """
    from .compiler import lower
    method = "exact"
    if isinstance(rounding_threshold_bits, dict):
        method = rounding_threshold_bits.get("method", "exact")
        rounding_threshold_bits = rounding_threshold_bits["n_bits"]
    assert method in ("exact", "approximate"), method
    circ = lower(params, state, spec, n_bits=n_bits,
                 rounding_threshold_bits=rounding_threshold_bits,
                 calib_absmax=calib_absmax, calib_data=calib_data,
                 range_margin=range_margin, residual_mode=residual_mode)
    max_r = max(op.spec.in_bits for op in circ.ops if isinstance(op, Tlu))
    p = tfhe_params or params_for_precision(max_r)
    return CompiledModule(circ, p, pbs_batch=pbs_batch,
                          rounding_method=method, drop_policy=drop_policy,
                          p_error=p_error)


def compile_ptq_model(params, state, spec, calib_data, *, n_bits: int = 5,
                      rounding_threshold_bits=6,
                      tfhe_params: TFHEParams | None = None,
                      pbs_batch: int = 2048) -> CompiledModule:
    """Post-training quantization compile of a trained FLOAT model.

    Mirrors ``compile_torch_model(model.module.feature, calib_data,
    rounding_threshold_bits, p_error, n_bits)`` — the reference's path for
    checkpoints whose model name carries no 'qat' tag (reference
    homomorphic_eval.py:95-98, 287-295): weights per-tensor-quantized to
    ``n_bits``, activation scales calibrated from ``calib_data`` with
    running-stats BatchNorm, then the standard lowering.
    """
    from ..models import quantize_float_model
    import jax.numpy as jnp
    params_q, spec_q = quantize_float_model(params, state,
                                            jnp.asarray(calib_data), spec,
                                            n_bits=n_bits)
    return compile_qat_model(params_q, state, spec_q, n_bits=n_bits,
                             rounding_threshold_bits=rounding_threshold_bits,
                             calib_data=calib_data,
                             tfhe_params=tfhe_params, pbs_batch=pbs_batch)
