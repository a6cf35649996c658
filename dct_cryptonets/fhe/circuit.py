"""Levelled-op + TLU circuit IR and its bit-exact integer simulator.

This is the framework's equivalent of the integer circuit Concrete-ML builds
from a Brevitas QAT model (ONNX import + calibration + BN folding + rounded
PBS insertion; invoked by the reference at homomorphic_eval.py:276-285) and
of Concrete's ``fhe='simulate'`` mode (the reference's de-facto accuracy
oracle, homomorphic_eval.py:333-347).

A circuit is a straight-line program over named integer tensors:

  * ``QuantIn``  — client-side float -> int input quantization
  * ``Conv``     — integer convolution (levelled in FHE)
  * ``PoolSum``  — window sum (levelled; the divide lives in the next TLU)
  * ``AddScaled``— ca*a + cb*b scale-unification add (levelled)
  * ``Tlu``      — per-channel table lookup on the rounded accumulator
                   (one PBS per tensor element in FHE)
  * ``Output``   — dequantize features for the clear classifier

TLU semantics (the bit-exactness contract between simulator and runtime):

  index  u = floor((acc + 2^(shift-1)) / 2^shift) + 2^(in_bits-1)
  output y = table[channel, u]

Encodings: every tensor t carries a bit budget ``n`` such that all integer
values satisfy |v| < 2^(n-1); in FHE t is encoded on the torus with
Delta_t = 2^(63 - n).  ``shift`` is always ``n_in - in_bits`` so the PBS's
nearest-window rounding coincides with the simulator's arithmetic rounding
(ties at exactly half a window are the only divergence, with probability
~2^-shift per element, further randomized by ciphertext noise).
"""
from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class TluSpec:
    in_bits: int          # r_eff: table has 2^r_eff entries
    shift: int            # accumulator LSBs dropped (n_in - in_bits)
    out_n: int            # bit budget of the output tensor (sets Delta_out)

    def __post_init__(self):
        assert self.in_bits >= 1 and self.shift >= 0


@dataclass
class QuantIn:
    scale: float          # x_int = clamp(round(x / scale), lo, hi)
    bits: int             # signed symmetric n_bits quantization
    n: int                # encoding budget of the produced tensor
    out: str = "x0"


@dataclass
class Conv:
    x: str
    w: np.ndarray         # (kh, kw, Cin, Cout) int32
    stride: int
    padding: int
    out: str


@dataclass
class PoolSum:
    x: str
    k: int
    out: str


@dataclass
class Window:
    """Strided spatially-shifted view with zero padding (levelled).

    out[i, j] = x[i*stride + dy - pad, j*stride + dx - pad]  (0 outside)
    Used to expand maxpool into pairwise maxes (max(a,b) = a + relu(b-a),
    one PBS per pair) for the RGB 7x7-stem topologies.
    """
    x: str
    dy: int
    dx: int
    stride: int
    pad: int
    out_h: int
    out_w: int
    out: str


@dataclass
class AddScaled:
    a: str
    ca: int               # simulator multiplier for a
    b: str
    cb: int
    ja: int               # FHE-side extra power-of-two (encoding align)
    jb: int
    out: str


@dataclass
class AddScaledPC:
    """Per-channel scaled add: out[..., c] = ca[c]*a[..., c] + cb[c]*b[..., c].

    The requant-elided residual add (compiler ``residual_mode='fused'``):
    raw conv accumulators carry a per-channel scale (conv scale x folded-BN
    gamma), so scale unification needs a multiplier pair *per channel*.
    Levelled in FHE — a per-channel integer scalar-mul broadcast over the
    trailing channel axis, no PBS (the per-channel interpretation scale and
    the folded BN bias live in the consuming TLU's per-channel table).
    Multipliers may be negative (negative BN gamma) or zero (dead channel:
    that branch contributes only its bias, which the TLU table carries).
    """
    a: str
    ca: np.ndarray        # (C,) int32 per-channel multipliers for a
    b: str
    cb: np.ndarray        # (C,) int32
    ja: int               # FHE-side extra power-of-two (encoding align)
    jb: int
    out: str


@dataclass
class Rescale:
    """Phase-only re-encoding: out carries the SAME integer value as x but
    at the finer budget n(out) = enc(x) - j (Delta multiplied by 2^j).

    Needed when a tensor's encoding was inflated by a wider consumer on a
    shared path (e.g. the stage-transition block input feeds both the wide
    conv1 and the narrow shortcut conv): the narrow TLU pre-scales its
    accumulator so the table keeps full rounding resolution.  Identity in
    the integer simulator; a single power-of-two scalar-mul in FHE
    (noise also scales by 2^j — negligible next to keyswitch/mod-switch
    noise for the small j seen in practice)."""
    x: str
    j: int
    out: str


@dataclass
class Tlu:
    x: str
    spec: TluSpec
    table: np.ndarray     # (C, 2^in_bits) int32
    out: str


@dataclass
class Output:
    x: str
    scale: float          # feats = y * scale


@dataclass
class Circuit:
    ops: list
    input_shape: tuple            # (H, W, C) of the float input
    n_budget: dict = field(default_factory=dict)   # tensor name -> n bits
    meta: dict = field(default_factory=dict)

    @property
    def num_pbs(self) -> int:
        """PBS invocations per single input sample (per-sample TLU sites)."""
        shapes = self.meta["shapes"]
        return sum(int(np.prod(shapes[op.x]))
                   for op in self.ops if isinstance(op, Tlu))

    def max_bit_width(self) -> int:
        """Largest accumulator bit budget — the reference checks this <= 16
        for FHE feasibility (homomorphic_eval.py:301-306)."""
        return max(self.n_budget.values())

    def dump(self) -> str:
        """Human-readable circuit listing — the framework's analog of the
        reference's MLIR dump (``homomorphic_eval.py:309-311`` writes
        Concrete's circuit to ``mlir.txt``).  One line per op with tensor
        shapes, bit budgets, scales/multipliers, and TLU geometry; suffixed
        with the per-sample cost summary the audit consumes."""
        shapes = self.meta.get("shapes", {})
        nb = self.n_budget

        def fmt(name):
            sh = "x".join(map(str, shapes.get(name, ())))
            return f"{name}:{sh}/n{nb.get(name, '?')}"

        lines = [f"circuit input={self.input_shape} "
                 f"n_bits={self.meta.get('n_bits')} "
                 f"r={self.meta.get('rounding_threshold_bits')} "
                 f"bit_width={self.meta.get('bit_width')}"]
        pbs = 0
        extract = 0
        for op in self.ops:
            if isinstance(op, QuantIn):
                lines.append(f"  quant_in scale={op.scale:.6g} "
                             f"bits={op.bits} -> {fmt(op.out)}")
            elif isinstance(op, Conv):
                lines.append(f"  conv {fmt(op.x)} w={op.w.shape} "
                             f"s={op.stride} p={op.padding} -> {fmt(op.out)}")
            elif isinstance(op, PoolSum):
                lines.append(f"  pool_sum {fmt(op.x)} k={op.k} "
                             f"-> {fmt(op.out)}")
            elif isinstance(op, Window):
                lines.append(f"  window {fmt(op.x)} d=({op.dy},{op.dx}) "
                             f"s={op.stride} -> {fmt(op.out)}")
            elif isinstance(op, AddScaled):
                lines.append(f"  add {op.ca}*{fmt(op.a)}<<{op.ja} + "
                             f"{op.cb}*{fmt(op.b)}<<{op.jb} -> {fmt(op.out)}")
            elif isinstance(op, AddScaledPC):
                lines.append(
                    f"  add_pc |ca|<= {int(np.abs(op.ca).max())}*"
                    f"{fmt(op.a)}<<{op.ja} + |cb|<="
                    f"{int(np.abs(op.cb).max())}*{fmt(op.b)}<<{op.jb} "
                    f"-> {fmt(op.out)}")
            elif isinstance(op, Rescale):
                lines.append(f"  rescale {fmt(op.x)} <<{op.j} "
                             f"-> {fmt(op.out)}")
            elif isinstance(op, Tlu):
                sites = int(np.prod(shapes[op.x]))
                pbs += sites
                extract += sites * op.spec.shift
                lines.append(f"  tlu {fmt(op.x)} r={op.spec.in_bits} "
                             f"shift={op.spec.shift} sites={sites} "
                             f"table={op.table.shape} -> {fmt(op.out)}")
            elif isinstance(op, Output):
                lines.append(f"  output {fmt(op.x)} scale={op.scale:.6g}")
        lines.append(f"  # per-sample: {pbs} PBS, {extract} dropped "
                     f"accumulator bits (exact-rounding extraction upper "
                     f"bound; the audit's keep_low reduces it), "
                     f"max bit-width {self.max_bit_width()}")
        return "\n".join(lines)

    def verify_encodings(self) -> list[str]:
        """Cross-check every op against the forward torus encodings.

        Levelled ops preserve Delta = 2^(63 - enc); a TLU materialized with
        ``in_bits + shift != enc(input)`` or an AddScaled whose ja/jb do not
        re-align actual input encodings would make encrypted execution
        misread phases (invisible to the integer simulator).  Returns a
        list of violation strings — empty means consistent.
        """
        nb = self.n_budget
        enc: dict = {}
        bad: list[str] = []
        for op in self.ops:
            if isinstance(op, QuantIn):
                enc[op.out] = op.n
            elif isinstance(op, (Conv, PoolSum, Window)):
                enc[op.out] = enc[op.x]
            elif isinstance(op, (AddScaled, AddScaledPC)):
                if op.ja != enc[op.a] - nb[op.out]:
                    bad.append(f"add {op.out}: ja={op.ja}, "
                               f"enc({op.a})={enc[op.a]}, n_out={nb[op.out]}")
                if op.jb != enc[op.b] - nb[op.out]:
                    bad.append(f"add {op.out}: jb={op.jb}, "
                               f"enc({op.b})={enc[op.b]}, n_out={nb[op.out]}")
                enc[op.out] = nb[op.out]
            elif isinstance(op, Rescale):
                if op.j < 0:
                    bad.append(f"rescale {op.out}: negative j={op.j}")
                enc[op.out] = enc[op.x] - op.j
            elif isinstance(op, Tlu):
                n_assumed = op.spec.in_bits + op.spec.shift
                if n_assumed != enc[op.x]:
                    bad.append(f"tlu on {op.x}: assumed n={n_assumed}, "
                               f"actual enc={enc[op.x]}")
                enc[op.out] = op.spec.out_n
            elif isinstance(op, Output):
                if nb.get(op.x) != enc[op.x]:
                    bad.append(f"output {op.x}: n_budget={nb.get(op.x)}, "
                               f"enc={enc[op.x]}")
        return bad


# ---------------------------------------------------------------------------
# simulator


def _conv_int(x, w, stride, padding):
    """Exact integer conv via f32 at ``Precision.HIGHEST`` (full f32, not
    the GPU's TF32 default): exact while every partial sum stays below
    2^24.  Checked bit-equal to an int64 conv at the flagship's widths on
    the GPU (chip_smoke.py) and the CPU (tests/test_pbs_engine.py)."""
    y = jax.lax.conv_general_dilated(
        x.astype(jnp.float32), jnp.asarray(w, jnp.float32),
        window_strides=(stride, stride),
        padding=((padding, padding), (padding, padding)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST,
    )
    return jnp.round(y).astype(jnp.int32)


def _pool_sum(x, k):
    y = jax.lax.reduce_window(
        x.astype(jnp.float32), 0.0, jax.lax.add,
        (1, k, k, 1), (1, k, k, 1), "VALID")
    return jnp.round(y).astype(jnp.int32)


def _window(x, op: "Window"):
    """Strided shifted view with zero padding; x: (B, H, W, C) int."""
    p = op.pad
    xp = jnp.pad(x, ((0, 0), (p, p), (p, p), (0, 0)))
    s = op.stride
    return xp[:, op.dy:op.dy + op.out_h * s:s,
              op.dx:op.dx + op.out_w * s:s, :]


def tlu_index(acc: jax.Array, spec: TluSpec) -> jax.Array:
    """The canonical rounded-index computation (shared with the runtime)."""
    if spec.shift > 0:
        acc = (acc + (1 << (spec.shift - 1))) >> spec.shift
    u = acc + (1 << (spec.in_bits - 1))
    return jnp.clip(u, 0, (1 << spec.in_bits) - 1)


def simulate(circuit: Circuit, x: jax.Array, return_env: bool = False):
    """Run the integer circuit on a float input batch (B, H, W, C).

    Returns the dequantized float features (B, F) — what the clear
    classifier consumes.  Bit-exact oracle for the encrypted runtime.

    ``return_env=True`` additionally returns the full wire -> integer
    tensor environment, so the encrypted runtime can decrypt-and-compare
    every TLU output against its clear value (realized-slip audit,
    ``CompiledModule.run_encrypted(check_ref=...)``).
    """
    env = {}
    out = None
    for op in circuit.ops:
        if isinstance(op, QuantIn):
            qmax = 2 ** (op.bits - 1) - 1
            qmin = -(2 ** (op.bits - 1))
            v = jnp.clip(jnp.round(x / op.scale), qmin, qmax)
            env[op.out] = v.astype(jnp.int32)
        elif isinstance(op, Conv):
            env[op.out] = _conv_int(env[op.x], op.w, op.stride, op.padding)
        elif isinstance(op, PoolSum):
            env[op.out] = _pool_sum(env[op.x], op.k)
        elif isinstance(op, Window):
            env[op.out] = _window(env[op.x], op)
        elif isinstance(op, Rescale):
            env[op.out] = env[op.x]          # integer value unchanged
        elif isinstance(op, AddScaled):
            env[op.out] = op.ca * env[op.a] + op.cb * env[op.b]
        elif isinstance(op, AddScaledPC):
            env[op.out] = (jnp.asarray(op.ca) * env[op.a]
                           + jnp.asarray(op.cb) * env[op.b])
        elif isinstance(op, Tlu):
            acc = env[op.x]
            u = tlu_index(acc, op.spec)
            table = jnp.asarray(op.table)            # (C, 2^r)
            # gather per channel: out[..., c] = table[c, u[..., c]]
            c_idx = jnp.arange(table.shape[0])
            env[op.out] = table[c_idx[None, None, None, :], u]
        elif isinstance(op, Output):
            y = env[op.x]
            out = y.reshape(y.shape[0], -1).astype(jnp.float32) * op.scale
        else:
            raise TypeError(f"unknown op {op!r}")
    assert out is not None, "circuit has no Output op"
    if return_env:
        return out, env
    return out


simulate_jit = partial(jax.jit, static_argnums=0)(simulate)


def collect_acc_ranges(circuit: Circuit, x: jax.Array) -> dict:
    """Run the integer simulation and record the PER-CHANNEL max |value| of
    every accumulator tensor (Conv/PoolSum/AddScaled outputs): dict
    name -> (C,) np.ndarray; scalar bound = ``.max()``.

    Used for calibration-based bit budgets (Concrete derives its circuit
    bit widths from calibration data the same way; worst-case weight bounds
    overflow 16 bits for the deeper reference nets).  The per-channel
    detail additionally drives the requant-elided residual adds, whose
    multiplier caps and add ranges are per-channel quantities."""

    def pc_max(v):
        return np.asarray(jnp.max(jnp.abs(v), axis=(0, 1, 2)))
    env = {}
    ranges = {}
    for op in circuit.ops:
        if isinstance(op, QuantIn):
            qmax = 2 ** (op.bits - 1) - 1
            qmin = -(2 ** (op.bits - 1))
            env[op.out] = jnp.clip(jnp.round(x / op.scale), qmin,
                                   qmax).astype(jnp.int32)
        elif isinstance(op, Conv):
            env[op.out] = _conv_int(env[op.x], op.w, op.stride, op.padding)
            ranges[op.out] = pc_max(env[op.out])
        elif isinstance(op, PoolSum):
            env[op.out] = _pool_sum(env[op.x], op.k)
            ranges[op.out] = pc_max(env[op.out])
        elif isinstance(op, Window):
            env[op.out] = _window(env[op.x], op)
        elif isinstance(op, Rescale):
            env[op.out] = env[op.x]          # integer value unchanged
        elif isinstance(op, AddScaled):
            env[op.out] = op.ca * env[op.a] + op.cb * env[op.b]
            ranges[op.out] = pc_max(env[op.out])
        elif isinstance(op, AddScaledPC):
            env[op.out] = (jnp.asarray(op.ca) * env[op.a]
                           + jnp.asarray(op.cb) * env[op.b])
            ranges[op.out] = pc_max(env[op.out])
        elif isinstance(op, Tlu):
            u = tlu_index(env[op.x], op.spec)
            table = jnp.asarray(op.table)
            c_idx = jnp.arange(table.shape[0])
            env[op.out] = table[c_idx[None, None, None, :], u]
        elif isinstance(op, Output):
            pass
    return ranges


def simulate_noisy(circuit: Circuit, x: jax.Array, key: jax.Array,
                   p_slip: float) -> jax.Array:
    """Integer simulation with the TFHE statistical fault model injected.

    Each PBS has probability ~p_error of landing one table window off
    (mod-switch/keyswitch noise crossing a window boundary; the reference
    exposes this as the ``p_error`` knob, io_utils.py:83).  This simulator
    flips every TLU index by +-1 with probability ``p_slip``, giving a fast
    statistical preview of encrypted-accuracy degradation without running
    ciphertexts — the same role Concrete's simulator plays for the
    reference's reliability analysis (homomorphic_eval.py:366-440).
    """
    env = {}
    out = None
    for op in circuit.ops:
        if isinstance(op, QuantIn):
            qmax = 2 ** (op.bits - 1) - 1
            qmin = -(2 ** (op.bits - 1))
            env[op.out] = jnp.clip(jnp.round(x / op.scale), qmin,
                                   qmax).astype(jnp.int32)
        elif isinstance(op, Conv):
            env[op.out] = _conv_int(env[op.x], op.w, op.stride, op.padding)
        elif isinstance(op, PoolSum):
            env[op.out] = _pool_sum(env[op.x], op.k)
        elif isinstance(op, Window):
            env[op.out] = _window(env[op.x], op)
        elif isinstance(op, Rescale):
            env[op.out] = env[op.x]          # integer value unchanged
        elif isinstance(op, AddScaled):
            env[op.out] = op.ca * env[op.a] + op.cb * env[op.b]
        elif isinstance(op, AddScaledPC):
            env[op.out] = (jnp.asarray(op.ca) * env[op.a]
                           + jnp.asarray(op.cb) * env[op.b])
        elif isinstance(op, Tlu):
            acc = env[op.x]
            u = tlu_index(acc, op.spec)
            key, k1, k2 = jax.random.split(key, 3)
            slip = jax.random.bernoulli(k1, p_slip, u.shape)
            direction = jax.random.rademacher(k2, u.shape, jnp.int32)
            u = jnp.clip(u + jnp.where(slip, direction, 0), 0,
                         (1 << op.spec.in_bits) - 1)
            table = jnp.asarray(op.table)
            c_idx = jnp.arange(table.shape[0])
            env[op.out] = table[c_idx[None, None, None, :], u]
        elif isinstance(op, Output):
            y = env[op.x]
            out = y.reshape(y.shape[0], -1).astype(jnp.float32) * op.scale
    assert out is not None
    return out
