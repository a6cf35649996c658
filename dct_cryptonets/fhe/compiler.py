"""Lower a trained QAT model to a levelled-op + TLU circuit.

Framework equivalent of ``compile_brevitas_qat_model`` (reference
homomorphic_eval.py:276-285): takes the trained params/state of a
:class:`~dct_cryptonets.models.resnet.ModelSpec` model plus calibration
info and emits a :class:`~.circuit.Circuit` whose integer semantics define
both the simulator and the encrypted runtime.

Key transformations (mirroring what Concrete-ML does to the reference nets):

* **Input quantization** with ``n_bits`` and a calibrated symmetric scale.
* **Weight quantization** with the Brevitas narrow-range per-tensor scheme
  the QAT training simulated (ops/quant.py).
* **BN folding**: BatchNorm becomes a per-channel affine absorbed into the
  following TLU table.
* **TLU fusion**: consecutive activation quantizers (stem QuantReLU followed
  by QuantIdentity, reference backbone.py:248-262) fuse into one table that
  applies both roundings — fewer PBS, identical integers.
* **Rounded TLUs** (``rounding_threshold_bits`` r): accumulators are rounded
  to at most r bits before lookup; ``shift = n - r`` where n is the input
  tensor's assigned bit budget, so the PBS's nearest-window rounding equals
  the simulator's arithmetic round-half-up.
* **Residual adds** unify branch scales with small integer multipliers
  (levelled, no PBS) plus power-of-two encoding alignment — Concrete's
  QuantizedAdd strategy.
* **Bit budgets**: lowering is two-phase.  The forward walk emits ops,
  integer ranges, and worst-case accumulator bounds; the budget pass then
  propagates each consumer's accumulator budget back to its producer tensor
  (max over consumers) and only then are TLU shifts chosen and tables
  materialized.  ``Circuit.max_bit_width()`` is what the reference's
  "max bit-width <= 16" feasibility check inspects
  (homomorphic_eval.py:301-306).
"""
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..models.resnet import ModelSpec
from ..ops.quant import act_qrange
from .circuit import (AddScaled, AddScaledPC, Circuit, Conv, Output, PoolSum,
                      QuantIn, Rescale, Tlu, TluSpec, Window)

ADD_MULT_BITS = 6   # residual-add scale-unification multiplier precision


def unify_multipliers(sa: float, sb: float, g: int = ADD_MULT_BITS,
                      cap_a: int | None = None, cap_b: int | None = None):
    """Smallest integer pair (ca, cb) with ca/cb ~ sa/sb to g-bit accuracy.

    The residual add computes v = ca*a + cb*b, interpreted at scale
    s_v = sa/ca; the representation error on the b branch is the relative
    error of ca/cb vs sa/sb.  The naive choice (round(ratio * 2^g), 2^g)
    meets the accuracy bound but amplifies both branches' ciphertext noise
    by up to 2^(2g) and inflates the add's integer range (more accumulator
    bits -> more exact-rounding extraction bootstraps).  Continued-fraction
    convergents give the accuracy at far smaller multipliers — directly
    shrinking the noise-audit variance and the v-tensor bit budgets.

    ``cap_a``/``cap_b`` bound each multiplier separately (default 2^g):
    requant-elided adds unify a raw conv-accumulator scale (tiny) against a
    quantized-activation scale (~100x larger), so the quantized branch needs
    a larger multiplier cap than the accuracy parameter g implies.

    Returns (ca, cb, s_v).
    """
    rho = sa / sb
    err_bound = 2.0 ** -(g + 1)
    cap_a = (1 << g) if cap_a is None else cap_a
    cap_b = (1 << g) if cap_b is None else cap_b

    best = None
    most_accurate = None
    # continued-fraction expansion of rho; track convergents p/q and probe
    # semiconvergents so the smallest adequate pair is not skipped
    p0, q0, p1, q1 = 0, 1, 1, 0
    x = rho
    for _ in range(64):
        a = int(x)
        for t in range(1, a + 1):       # semiconvergents p0+t*p1 / q0+t*q1
            p, q = p0 + t * p1, q0 + t * q1
            if not (1 <= p <= cap_a and 1 <= q <= cap_b):
                continue
            # realized b-branch error with s_v = sa/p: |s_v*q - sb| / sb
            err = abs(rho * q / p - 1.0)
            if most_accurate is None or err < most_accurate[0]:
                most_accurate = (err, p, q)
            if err <= err_bound and (best is None
                                     or p * p + q * q < best[0]):
                best = (p * p + q * q, p, q)
        p0, q0, p1, q1 = p1, q1, p0 + a * p1, q0 + a * q1
        if p1 > cap_a and q1 > cap_b:
            break
        frac = x - a
        if frac <= 1e-12:
            break
        x = 1.0 / frac
    if best is None:
        # ratio not representable to g-bit accuracy under the cap (branch
        # scales far apart); take the most accurate pair found — always
        # at least as good as the naive (round(ratio * 2^g), 2^g) choice
        if most_accurate is None:       # rho outside [1/cap_b, cap_a]
            return ((cap_a, 1, sa / cap_a) if rho > 1 else (1, cap_b, sa))
        _, ca, cb = most_accurate
        return ca, cb, sa / ca
    _, ca, cb = best
    return ca, cb, sa / ca


def unify_multipliers_pc(ka, kb, bound_a, bound_b, out_step,
                         g: int = ADD_MULT_BITS):
    """Per-channel multiplier pairs for a requant-elided residual add.

    Channel c of branch a carries value ``ka[c] * a + bias`` (raw conv
    accumulator with folded BN, or a quantized activation with constant
    ``ka``); same for b.  Returns int32 arrays (ca, cb) and float s_v with
    ``s_v[c] = |ka[c]| / |ca[c]|`` such that the integer
    ``v = ca[c]*a + cb[c]*b`` interpreted at ``s_v[c]`` approximates
    ``ka[c]*a + kb[c]*b`` to g-bit relative accuracy per branch.

    Signs of ka/kb (negative folded-BN gammas) move into the multipliers.
    A branch whose full-scale contribution ``|k|*bound`` is below a quarter
    of the consuming TLU's output step ``out_step`` is dropped (multiplier
    0) — it only shifts the output by sub-round-off and its bias still
    lands in the TLU table.

    Pair selection is *range-aware*: the a-branch is represented exactly
    (s_v = ra/p) and the b-branch's misrepresentation is an ABSOLUTE error
    ``|s_v*q - rb| * bound_b`` — adequacy requires it below out_step/4
    (a quarter of the consuming TLU's output LSB), which for raw-vs-raw
    accumulator adds is a far weaker demand than g-bit relative accuracy.
    Among adequate semiconvergent pairs the one minimizing the add range
    ``max(p*bound_a, q*bound_b)`` wins: range is what sets the add's bit
    budget (exact-rounding extraction bootstraps) and the multiplier
    magnitude is what amplifies ciphertext noise — both the quantities the
    circuit noise audit pays for.  A hard per-branch range cap of 2^13
    keeps the add accumulator within ~15 bits.
    """
    ka = np.asarray(ka, np.float64)
    kb = np.asarray(kb, np.float64)
    C = ka.shape[0]
    bound_a = np.broadcast_to(np.asarray(bound_a, np.float64), (C,))
    bound_b = np.broadcast_to(np.asarray(bound_b, np.float64), (C,))
    ca = np.zeros(C, np.int32)
    cb = np.zeros(C, np.int32)
    s_v = np.ones(C, np.float64)
    drop_eps = float(out_step) / 4.0
    RANGE_CAP = 1 << 13
    for c in range(C):
        ra, rb = abs(float(ka[c])), abs(float(kb[c]))
        full_a, full_b = ra * bound_a[c], rb * bound_b[c]
        if full_a < drop_eps and full_b < drop_eps:
            s_v[c] = max(ra, rb, 1e-12)
            continue                       # both branches sub-round-off
        if full_a < drop_eps:
            cb[c] = 1 if kb[c] >= 0 else -1
            s_v[c] = rb
            continue
        if full_b < drop_eps:
            ca[c] = 1 if ka[c] >= 0 else -1
            s_v[c] = ra
            continue
        cap_a = max(1, int(RANGE_CAP // max(bound_a[c], 1.0)))
        cap_b = max(1, int(RANGE_CAP // max(bound_b[c], 1.0)))
        # adequacy: absolute b-branch error <= out_step/4; never looser
        # than 2^-(g+1) relative would allow at full scale
        err_req = max(drop_eps / full_b, 0.0)
        err_req = min(err_req, 0.5)
        rho = ra / rb
        best = None           # (range, p, q) among adequate pairs
        most_accurate = None  # (err, p, q) fallback
        p0, q0, p1, q1 = 0, 1, 1, 0
        x = rho
        for _ in range(64):
            a = int(x)
            for t in range(1, a + 1):
                p, q = p0 + t * p1, q0 + t * q1
                if not (1 <= p <= cap_a and 1 <= q <= cap_b):
                    continue
                err = abs(rho * q / p - 1.0)
                if most_accurate is None or err < most_accurate[0]:
                    most_accurate = (err, p, q)
                if err <= err_req:
                    rng = max(p * bound_a[c], q * bound_b[c])
                    if best is None or rng < best[0]:
                        best = (rng, p, q)
            p0, q0, p1, q1 = p1, q1, p0 + a * p1, q0 + a * q1
            if p1 > cap_a and q1 > cap_b:
                break
            frac = x - a
            if frac <= 1e-12:
                break
            x = 1.0 / frac
        if best is not None:
            _, p, q = best
        elif most_accurate is not None:
            _, p, q = most_accurate
        else:                             # rho outside the cap window
            p, q = (cap_a, 1) if rho > 1 else (1, cap_b)
        ca[c] = p if ka[c] >= 0 else -p
        cb[c] = q if kb[c] >= 0 else -q
        s_v[c] = ra / p
    return ca, cb, s_v


def _quantize_weight(w, bits):
    """Brevitas narrow-range per-tensor weight quantization (ops/quant.py)."""
    w = np.asarray(w, np.float64)
    qmax = 2 ** (bits - 1) - 1
    scale = max(np.abs(w).max(), 1e-8) / qmax
    w_int = np.clip(np.round(w / scale), -qmax, qmax).astype(np.int32)
    return w_int, float(scale)


def _bn_affine(p, s, eps=1e-5):
    """Per-channel (A, B): BN(v) = A*v + B using running stats."""
    gamma = np.asarray(p["gamma"], np.float64)
    beta = np.asarray(p["beta"], np.float64)
    mean = np.asarray(s["mean"], np.float64)
    var = np.asarray(s["var"], np.float64)
    A = gamma / np.sqrt(var + eps)
    return A, beta - A * mean


def _bits_for(bound: int) -> int:
    """Signed bit budget n with |v| <= bound <= 2^(n-1) - 1."""
    return int(np.ceil(np.log2(bound + 2))) + 1


@dataclass
class _Tensor:
    name: str
    shape: tuple            # (H, W, C) per sample
    lo: int
    hi: int
    scale: float            # float value = scale * int (per tensor)

    @property
    def absmax(self):
        return max(abs(self.lo), abs(self.hi))


@dataclass
class _TluSite:
    """Deferred TLU: tables materialize after budget assignment."""
    acc_name: str
    out_name: str
    shape: tuple
    acc_bound: int
    cout: int
    value_fn: Callable      # (channel col, acc row) -> float values
    out_scale: float
    out_lo: int
    out_hi: int


def lower(params, state, spec: ModelSpec, *, n_bits: int = 5,
          rounding_threshold_bits: int = 6,
          calib_absmax: float | None = None,
          calib_data=None, range_margin: float = 1.0,
          residual_mode: str = "fused") -> Circuit:
    """Compile trained (params, state) of a quantized model into a Circuit.

    With ``calib_data`` (a float input batch), accumulator bit budgets come
    from observed calibration ranges (x ``range_margin``) instead of
    worst-case weight bounds — like Concrete's calibration, and required
    for the deeper nets whose worst-case bounds exceed 16 bits.

    ``range_margin``: safety factor on the observed ranges.  The default
    1.0 is Concrete-ML parity (it calibrates with the exact observed
    min/max and accepts that out-of-calibration accumulators at eval time
    wrap the PBS phase); 2.0 spends one extra accumulator bit per TLU
    (= one extra exact-rounding extraction bootstrap per site) to make
    that failure mode an order of magnitude rarer.

    ``residual_mode``: ``'fused'`` (default) elides the ``quant_out`` /
    ``quant_sc`` requant TLUs at every residual add — the raw conv
    accumulators (BN folded into a per-channel scale + bias) feed the add
    through per-channel minimal multipliers (:class:`~.circuit.AddScaledPC`)
    and the following relu TLU's per-channel table absorbs scale and bias.
    This removes one PBS per block output element (~30% of the flagship
    circuit's bootstraps) and *raises* arithmetic fidelity (no intermediate
    requantization), at the price of a slightly wider add accumulator.
    ``'requant'`` reproduces the reference graph literally (Brevitas
    QuantIdentity nodes -> Concrete TLUs, reference backbone.py:94-104).
    """
    assert residual_mode in ("fused", "requant"), residual_mode
    circ = _lower_once(params, state, spec, n_bits=n_bits,
                       rounding_threshold_bits=rounding_threshold_bits,
                       calib_absmax=calib_absmax, residual_mode=residual_mode)
    if calib_data is None:
        return circ
    from .circuit import collect_acc_ranges
    import jax.numpy as jnp
    x = jnp.asarray(calib_data)

    # Calibration fixpoint.  Re-lowering with calibrated bounds changes the
    # circuit itself (TLU shifts, and in fused mode the per-channel add
    # multipliers, whose caps track the bounds) — so ranges measured on one
    # iteration's circuit may under-cover the next one's accumulators,
    # which the simulator would silently clip but encrypted phases would
    # WRAP.  Iterate: lower -> measure -> grow bounds (monotone, elementwise
    # max) until every observed range fits its own circuit's bound.
    bounds: dict = {}
    bounds_pc: dict = {}
    for _ in range(6):
        ranges = collect_acc_ranges(circ, x)
        grew = False
        for name, v in ranges.items():
            # ceil: the bound must cover the observed range even at 1.0
            b = max(1, int(np.ceil(float(np.max(v)) * range_margin)))
            pc = np.maximum(np.ceil(np.asarray(v, np.float64)
                                    * range_margin), 1.0)
            if name not in bounds or b > bounds[name]:
                bounds[name] = max(b, bounds.get(name, 0))
                grew = True
            old_pc = bounds_pc.get(name)
            if old_pc is None:
                bounds_pc[name] = pc
                grew = True
            elif np.any(pc > old_pc):
                bounds_pc[name] = np.maximum(pc, old_pc)
                grew = True
        if not grew:
            break
        circ = _lower_once(params, state, spec, n_bits=n_bits,
                           rounding_threshold_bits=rounding_threshold_bits,
                           calib_absmax=calib_absmax, bounds_override=bounds,
                           bounds_pc_override=bounds_pc,
                           residual_mode=residual_mode)
    else:
        raise RuntimeError("calibration bounds did not stabilize")
    return circ


def _lower_once(params, state, spec: ModelSpec, *, n_bits: int = 5,
                rounding_threshold_bits: int = 6,
                calib_absmax: float | None = None,
                bounds_override: dict | None = None,
                bounds_pc_override: dict | None = None,
                residual_mode: str = "fused") -> Circuit:
    assert spec.quantized, "lower() expects a QAT model"
    st = spec.stem
    bw = spec.bit_width
    r = rounding_threshold_bits

    ops: list = []
    shapes: dict = {}
    sites: list[_TluSite] = []
    n_budget: dict = {}
    counter = [0]

    def fresh(p):
        counter[0] += 1
        return f"{p}{counter[0]}"

    def scale_of(node):
        return float(np.maximum(np.asarray(node["scale"]), 1e-8))

    def conv_bound_pc(w_int, x: _Tensor) -> np.ndarray:
        """Worst-case per-output-channel |accumulator| bound."""
        w = w_int.astype(np.int64).reshape(-1, w_int.shape[-1])
        hi = np.where(w > 0, w * x.hi, w * x.lo).sum(0)
        lo = np.where(w > 0, w * x.lo, w * x.hi).sum(0)
        return np.maximum(np.maximum(hi, -lo), 1)

    def conv_bound(w_int, x: _Tensor) -> int:
        return int(conv_bound_pc(w_int, x).max())

    def add_site(acc_name, shape, bound, cout, value_fn, s_out, lo, hi):
        out = fresh("t")
        sites.append(_TluSite(acc_name, out, shape, bound, cout, value_fn,
                              s_out, lo, hi))
        shapes[out] = shape
        n_budget[acc_name] = _bits_for(bound)
        return _Tensor(out, shape, lo, hi, s_out)

    def bound_of(name: str, worst: int) -> int:
        if bounds_override and name in bounds_override:
            return min(worst, bounds_override[name])
        return worst

    def bound_of_pc(name: str, worst_pc: np.ndarray) -> np.ndarray:
        if bounds_pc_override and name in bounds_pc_override:
            return np.minimum(worst_pc, bounds_pc_override[name])
        return worst_pc

    def conv_tlu(x: _Tensor, w, bn_p, bn_s, stride, padding, *,
                 fused_relu_scale=None, out_scale, out_relu=False):
        """Conv -> BN -> (fused relu-quant ->) final quant TLU."""
        w_int, s_w = _quantize_weight(w, bw)
        kh = w_int.shape[0]
        oh = (x.shape[0] + 2 * padding - kh) // stride + 1
        ow = (x.shape[1] + 2 * padding - kh) // stride + 1
        cout = w_int.shape[-1]
        acc = fresh("acc")
        bound = bound_of(acc, conv_bound(w_int, x))
        ops.append(Conv(x.name, w_int, stride, padding, acc))
        shapes[acc] = (oh, ow, cout)

        A, Bb = _bn_affine(bn_p, bn_s)
        k = x.scale * s_w * A

        if fused_relu_scale is not None:
            lo_r, hi_r = act_qrange(bw, signed=False, relu=True)

            def value_fn(c, a, k=k, Bb=Bb, s_r=fused_relu_scale):
                v = k[c] * a + Bb[c]
                return np.clip(np.round(v / s_r), lo_r, hi_r) * s_r
        else:
            def value_fn(c, a, k=k, Bb=Bb):
                return k[c] * a + Bb[c]

        lo_q, hi_q = act_qrange(bw, signed=True, relu=out_relu)
        return add_site(acc, (oh, ow, cout), bound, cout, value_fn,
                        out_scale, lo_q, hi_q)

    def conv_acc(x: _Tensor, w, bn_p, bn_s, stride, padding):
        """Conv -> folded BN as a RAW accumulator branch (no requant TLU).

        Returns (acc_name, shape, k, bias, bound_pc): channel c of the
        accumulator carries the float value ``k[c] * acc + bias[c]`` with
        k = x.scale * s_w * bn_gamma_hat (sign included) — the
        requant-elided residual path (``residual_mode='fused'``)."""
        w_int, s_w = _quantize_weight(w, bw)
        kh = w_int.shape[0]
        oh = (x.shape[0] + 2 * padding - kh) // stride + 1
        ow = (x.shape[1] + 2 * padding - kh) // stride + 1
        cout = w_int.shape[-1]
        acc = fresh("acc")
        ops.append(Conv(x.name, w_int, stride, padding, acc))
        shapes[acc] = (oh, ow, cout)
        A, Bb = _bn_affine(bn_p, bn_s)
        k = x.scale * s_w * A
        bound_pc = bound_of_pc(acc, conv_bound_pc(w_int, x))
        return acc, (oh, ow, cout), k, Bb, bound_pc

    # ---- input quantization
    # The QAT model carries its own input quantizer (stem QuantIdentity,
    # reference backbone.py:231, 245); its learned scale and bit width define
    # the circuit input — matching how Concrete-ML imports Brevitas input
    # quant nodes (`n_bits` would only apply to models without one).
    sp, ss = params["stem"], state["stem"]
    s_in = float(np.maximum(np.asarray(sp["quant_in"]["scale"]), 1e-8))
    in_bits = bw
    qmax_in = 2 ** (in_bits - 1) - 1
    qmin_in = -(2 ** (in_bits - 1))
    H = W = spec.img_size
    x = _Tensor("x0", (H, W, spec.in_channels), qmin_in, qmax_in, s_in)
    shapes["x0"] = x.shape
    qin = QuantIn(s_in, in_bits, 0, "x0")
    ops.append(qin)

    def maxpool_expand(xin: _Tensor, k: int, stride: int, pad: int) -> _Tensor:
        """MaxPool2d(k, stride, pad) as pairwise maxes:
        max(a, b) = a + relu(b - a) — one PBS per pair per site
        (Concrete lowers torch MaxPool the same way).  Inputs must be
        non-negative (they are: the stem QuantReLU precedes pool1,
        reference backbone.py:248-259) so zero padding is max-neutral."""
        oh = (xin.shape[0] + 2 * pad - k) // stride + 1
        ow = (xin.shape[1] + 2 * pad - k) // stride + 1
        cout = xin.shape[-1]
        assert xin.lo >= 0, "maxpool expansion requires non-negative inputs"

        def view(dy, dx):
            nm = fresh("w")
            ops.append(Window(xin.name, dy, dx, stride, pad, oh, ow, nm))
            shapes[nm] = (oh, ow, cout)
            return _Tensor(nm, (oh, ow, cout), xin.lo, xin.hi, xin.scale)

        taps = [(dy, dx) for dy in range(k) for dx in range(k)]
        cur = view(*taps[0])
        for dy, dx in taps[1:]:
            t = view(dy, dx)
            d_name = fresh("v")
            ops.append(AddScaled(t.name, 1, cur.name, -1, 0, 0, d_name))
            shapes[d_name] = (oh, ow, cout)
            d_bound = bound_of(d_name, max(xin.hi, 1))
            # relu TLU at the input scale: table[u] = max(u, 0)
            r = add_site(d_name, (oh, ow, cout), d_bound, cout,
                         lambda c, a, s=xin.scale: s * a + 0.0 * c,
                         xin.scale, 0, xin.hi)
            m_name = fresh("v")
            ops.append(AddScaled(cur.name, 1, r.name, 1, 0, 0, m_name))
            shapes[m_name] = (oh, ow, cout)
            cur = _Tensor(m_name, (oh, ow, cout), 0, xin.hi, xin.scale)
        return cur

    # ---- stem: conv1 -> BN -> (QuantReLU) -> (maxpool) -> QuantIdentity
    relu_s = scale_of(sp["relu1"]) if st.relu1 else None
    if st.pool1_kernel is None:
        h = conv_tlu(x, np.asarray(sp["conv"]["w"]), sp["bn"], ss["bn"],
                     st.conv1_stride, st.conv1_padding,
                     fused_relu_scale=relu_s,
                     out_scale=scale_of(sp["quant_stem"]))
    else:
        # relu TLU stands alone (pool sits between relu and quant_stem)
        h = conv_tlu(x, np.asarray(sp["conv"]["w"]), sp["bn"], ss["bn"],
                     st.conv1_stride, st.conv1_padding,
                     out_scale=relu_s if relu_s else scale_of(sp["quant_stem"]),
                     out_relu=True)
        h = maxpool_expand(h, st.pool1_kernel, st.pool1_stride, 1)
        # requant to the stem QuantIdentity scale
        s_qs = scale_of(sp["quant_stem"])
        lo_q, hi_q = act_qrange(bw, signed=True, relu=False)
        h = add_site(h.name, h.shape, bound_of(h.name, max(h.hi, 1)),
                     h.shape[-1],
                     lambda c, a, s=h.scale: s * a + 0.0 * c,
                     s_qs, lo_q, hi_q)

    # ---- blocks
    for bp, bs, (indim, outdim, half) in zip(
            params["blocks"], state["blocks"], spec.block_layout()):
        stride = 2 if half else 1
        # relu1 after BN1 is a QuantReLU (unsigned output)
        a1 = conv_tlu(h, np.asarray(bp["c1"]["w"]), bp["bn1"], bs["bn1"],
                      stride, 1, out_scale=scale_of(bp["relu1"]),
                      out_relu=True)
        s_r2 = scale_of(bp["relu2"])
        lo2, hi2 = act_qrange(bw, signed=False, relu=True)

        if residual_mode == "fused":
            # requant-elided residual: raw conv2 / shortcut accumulators
            # (BN folded into per-channel scale+bias) feed the add through
            # per-channel minimal multipliers; relu2's per-channel table
            # absorbs scale and bias.  Elides the quant_out / quant_sc PBS
            # layers entirely (one bootstrap per block output element).
            an, a_shape, ka, bias_a, bnd_a = conv_acc(
                a1, np.asarray(bp["c2"]["w"]), bp["bn2"], bs["bn2"], 1, 1)
            if indim != outdim:
                bn_, _, kb, bias_b, bnd_b = conv_acc(
                    h, np.asarray(bp["shortcut"]["w"]), bp["bn_sc"],
                    bs["bn_sc"], stride, 0)
            else:
                bn_ = h.name
                kb = np.full(outdim, h.scale)
                bias_b = np.zeros(outdim)
                bnd_b = np.full(outdim, float(h.absmax))
            ca, cb, s_v = unify_multipliers_pc(ka, kb, bnd_a, bnd_b, s_r2)
            bias_v = bias_a + bias_b
            v_name = fresh("v")
            ops.append(AddScaledPC(an, ca, bn_, cb, 0, 0, v_name))
            shapes[v_name] = a_shape
            v_bound = int(max((np.abs(ca) * bnd_a
                               + np.abs(cb) * bnd_b).max(), 1))
            h = add_site(v_name, a_shape, v_bound, a_shape[-1],
                         lambda c, a, s_v=s_v, b=bias_v: s_v[c] * a + b[c],
                         s_r2, lo2, hi2)
            continue

        a2 = conv_tlu(a1, np.asarray(bp["c2"]["w"]), bp["bn2"], bs["bn2"],
                      1, 1, out_scale=scale_of(bp["quant_out"]))

        if indim != outdim:
            sc = conv_tlu(h, np.asarray(bp["shortcut"]["w"]), bp["bn_sc"],
                          bs["bn_sc"], stride, 0,
                          out_scale=scale_of(bp["quant_sc"]))
        else:
            sc = h

        # residual add with minimal-multiplier scale unification (levelled)
        ca, cb, s_v = unify_multipliers(a2.scale, sc.scale)
        v_name = fresh("v")
        ops.append(AddScaled(a2.name, ca, sc.name, cb, 0, 0, v_name))
        shapes[v_name] = a2.shape
        v_bound = bound_of(v_name, max(abs(ca * a2.lo + cb * sc.lo),
                                       abs(ca * a2.hi + cb * sc.hi), 1))

        h = add_site(v_name, a2.shape, v_bound, a2.shape[-1],
                     lambda c, a, s_v=s_v: s_v * a + 0.0 * c,
                     s_r2, lo2, hi2)

    # ---- head: avgpool sum -> quant TLU -> output
    kp = st.avgpool_kernel
    p_name = fresh("pool")
    ops.append(PoolSum(h.name, kp, p_name))
    oh, ow = h.shape[0] // kp, h.shape[1] // kp
    shapes[p_name] = (oh, ow, h.shape[-1])
    p_bound = bound_of(p_name, kp * kp * h.absmax)
    s_pool = scale_of(params["head"]["quant_pool"])
    lo_p, hi_p = act_qrange(bw, signed=True, relu=False)
    inv = h.scale / (kp * kp)
    y = add_site(p_name, (oh, ow, h.shape[-1]), p_bound, h.shape[-1],
                 lambda c, a, inv=inv: inv * a + 0.0 * c,
                 s_pool, lo_p, hi_p)
    ops.append(Output(y.name, y.scale))

    # ---- budget pass: propagate consumer budgets back to producer tensors.
    # Walk in REVERSE op order so every consumer's budget is final before
    # its producers' inputs are constrained (levelled chains like the
    # maxpool max(a,b) expansion feed AddScaled into AddScaled).
    def propagate():
        for op in reversed(ops):
            if isinstance(op, (Conv, PoolSum)):
                n_budget[op.x] = max(n_budget.get(op.x, 0), n_budget[op.out])
            elif isinstance(op, Window):
                n_budget[op.x] = max(n_budget.get(op.x, 0),
                                     n_budget.get(op.out, 0))
            elif isinstance(op, (AddScaled, AddScaledPC)):
                n_budget[op.a] = max(n_budget.get(op.a, 0), n_budget[op.out])
                n_budget[op.b] = max(n_budget.get(op.b, 0), n_budget[op.out])

    # Encoding fixpoint.  A tensor's FHE encoding Delta = 2^(63 - enc) is
    # set by its *producer* and is shared by every consumer; levelled ops
    # (Conv/PoolSum/Window) preserve Delta, so a tensor consumed by two
    # paths with different budget demands carries the max — and any TLU on
    # a downstream accumulator must be materialized against that actual
    # encoding, not its own local budget (otherwise the PBS misreads the
    # phase by the budget gap; this bit the stage-transition shortcut convs,
    # whose input is shared with the wider conv1 path).
    def encodings() -> dict:
        enc = {s.out_name: n_budget.get(s.out_name, 0) for s in sites}
        for op in ops:
            if isinstance(op, QuantIn):
                enc[op.out] = n_budget.get(op.out, 0)
            elif isinstance(op, (Conv, PoolSum, Window)):
                enc[op.out] = enc[op.x]
            elif isinstance(op, (AddScaled, AddScaledPC)):
                enc[op.out] = n_budget[op.out]
        return enc

    for _ in range(8):
        propagate()
        changed = False
        # margin bits: if round-up at the bound edge could spill past the
        # top table window, widen that accumulator's budget
        for s in sites:
            n = n_budget[s.acc_name]
            r_eff = min(r, n)
            shift = n - r_eff
            if shift > 0 and s.acc_bound > 2 ** (n - 1) - 2 ** (shift - 1):
                n_budget[s.acc_name] = n + 1
                changed = True
        if not changed:
            break
    else:
        raise RuntimeError("encoding/budget fixpoint did not converge")
    enc = encodings()

    # alignment exponents for AddScaled inputs use actual input encodings
    for op in ops:
        if isinstance(op, (AddScaled, AddScaledPC)):
            op.ja = enc[op.a] - n_budget[op.out]
            op.jb = enc[op.b] - n_budget[op.out]
            assert op.ja >= 0 and op.jb >= 0

    qin.n = n_budget["x0"]

    # ---- materialize TLU tables with final budgets
    tlu_ops = {}
    for s in sites:
        n = n_budget[s.acc_name]
        r_eff = min(r, n)
        shift = n - r_eff
        size = 1 << r_eff
        u = np.arange(size)
        acc_repr = (u - (size >> 1)).astype(np.float64) * float(2 ** shift)
        c = np.arange(s.cout)
        vals = s.value_fn(c[:, None], acc_repr[None, :])
        table = np.clip(np.round(vals / s.out_scale), s.out_lo, s.out_hi)
        out_n = n_budget.get(s.out_name, _bits_for(max(abs(s.out_lo),
                                                       abs(s.out_hi))))
        n_budget.setdefault(s.out_name, out_n)
        seq = []
        acc_in = s.acc_name
        j = enc[s.acc_name] - n
        assert j >= 0, (s.acc_name, enc[s.acc_name], n)
        if j > 0:
            # accumulator arrives encoded wider than its own budget (a
            # sibling consumer inflated the shared producer); re-encode
            # phase-only so the table keeps full rounding resolution
            acc_in = s.acc_name + "_rs"
            shapes[acc_in] = s.shape
            n_budget[acc_in] = n
            seq.append(Rescale(s.acc_name, j, acc_in))
        seq.append(Tlu(acc_in, TluSpec(r_eff, shift, out_n),
                       table.astype(np.int32), s.out_name))
        tlu_ops[s.acc_name] = seq

    # splice Rescale/Tlu ops right after their accumulator producers
    final_ops = []
    for op in ops:
        final_ops.append(op)
        out = getattr(op, "out", None)
        if out in tlu_ops:
            final_ops.extend(tlu_ops[out])

    return Circuit(final_ops, (H, W, spec.in_channels), dict(n_budget),
                   {"shapes": dict(shapes), "n_bits": n_bits,
                    "rounding_threshold_bits": r, "bit_width": bw})
