"""Float + QAT DCT-ResNet models as pure-functional JAX.

Re-designs the reference model layer (reference models/backbone.py:107-342,
utils.py:14-47): NHWC layout, explicit param/state pytrees, one
jittable forward.  The architecture is declarative (:class:`ModelSpec`), and
the same spec drives three consumers:

  * ``forward``            — float / fake-quant QAT training & clear eval
  * ``fhe.compiler.lower`` — integer circuit extraction (simulate/execute)
  * ``parallel``           — sharded training/eval

Topology parity with the reference:
  * stem per :mod:`.topology` (1x1 conv stem for DCT inputs, classic 7x7+pool
    for RGB 224^2), optional relu1, optional maxpool  (backbone.py:229-262)
  * SimpleBlock/SimpleQBlock residual blocks           (backbone.py:18-104)
  * ``skip_single_downsample``: downsample only at stage index >= 2
    (ResNet-20 variant, backbone.py:164-167)
  * avgpool(k, stride=k, VALID) + flatten + clear linear classifier; the
    trunk/classifier split is what gets encrypted vs stays clear
    (utils.py:14-27, homomorphic_eval.py:277, 341)

Quantization node placement matches SimpleQBlock exactly: quant_in at the
input, QuantReLU after BN1, QuantIdentity after BN2 and on the conv shortcut
branch, QuantReLU after the residual add, QuantIdentity after avgpool.
"""
import dataclasses
from dataclasses import dataclass, field
import math

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.quant import (
    fake_quant_act_signed,
    fake_quant_relu,
    fake_quant_weight,
)
from .topology import StemSpec, stem_spec


@dataclass(frozen=True)
class ModelSpec:
    name: str
    block_counts: tuple
    widths: tuple
    in_channels: int
    img_size: int
    num_classes: int = 10
    bit_width: int = 4
    quantized: bool = True
    skip_single_downsample: bool = False
    stem_override: StemSpec | None = None  # for tests / custom topologies

    @property
    def stem(self) -> StemSpec:
        if self.stem_override is not None:
            return self.stem_override
        return stem_spec(self.widths[0], self.in_channels, self.img_size)

    def block_layout(self):
        """Yield (indim, outdim, half_res) per block, mirroring
        backbone.py:264-273."""
        indim = self.widths[0]
        for i, n in enumerate(self.block_counts):
            for j in range(n):
                if self.skip_single_downsample:
                    half = (i >= 2) and (j == 0)
                else:
                    half = (i >= 1) and (j == 0)
                yield indim, self.widths[i], half
                indim = self.widths[i]


def trunk_feat_dim(spec: "ModelSpec") -> int:
    """Flattened feature count after the trunk's avgpool, from the actual
    spatial arithmetic (not assumed 1x1).  The reference hardcodes
    ``final_feat_dim = indim`` (backbone.py:280) which is only correct when
    the avgpool output is 1x1; its own '48_3_32' RGB entry leaves a 16x16
    map that AvgPool2d(7) reduces to 2x2 (256 flattened features vs its
    Linear(64) — not buildable as shipped, same class of defect as the
    '48_24_16' topology hole documented in models/topology.py).  Deriving
    the true count makes every topology entry self-consistent."""
    st = spec.stem
    oh = (spec.img_size + 2 * st.conv1_padding
          - st.conv1_kernel) // st.conv1_stride + 1
    if st.pool1_kernel is not None:
        oh = (oh + 2 * 1 - st.pool1_kernel) // st.pool1_stride + 1
    for _, _, half in spec.block_layout():
        oh = (oh + 2 - 3) // (2 if half else 1) + 1
    oh //= st.avgpool_kernel
    return oh * oh * spec.widths[-1]


def build_spec(model: str, *, in_channels: int, img_size: int,
               num_classes: int = 10, bit_width: int = 4) -> ModelSpec:
    """Model registry, mirroring reference ``model_dict`` (io_utils.py:5-10)."""
    m = model.lower()
    if m == "resnet20" or m == "resnet20qat":
        return ModelSpec(
            name=model, block_counts=(3, 3, 3), widths=(48, 56, 64),
            in_channels=in_channels, img_size=img_size, num_classes=num_classes,
            bit_width=bit_width, quantized=m.endswith("qat"),
            skip_single_downsample=True)
    if m == "resnet18" or m == "resnet18qat":
        return ModelSpec(
            name=model, block_counts=(2, 2, 2, 2), widths=(64, 128, 256, 512),
            in_channels=in_channels, img_size=img_size, num_classes=num_classes,
            bit_width=bit_width, quantized=m.endswith("qat"),
            skip_single_downsample=False)
    raise ValueError(f"unknown model {model!r}")


# ---------------------------------------------------------------------------
# initialization


def _conv_init(key, kh, kw, cin, cout):
    """Fan-in normal init, reference init_layer (backbone.py:8-12):
    std = sqrt(2 / (kh * kw * cout))."""
    n = kh * kw * cout
    return jax.random.normal(key, (kh, kw, cin, cout)) * math.sqrt(2.0 / n)


def _bn_init(c):
    return {"gamma": jnp.ones((c,)), "beta": jnp.zeros((c,))}


def _bn_state(c):
    return {"mean": jnp.zeros((c,)), "var": jnp.ones((c,))}


def _act_scale():
    # Brevitas QuantIdentity(scaling_init=1.0); learned thereafter (LSQ).
    return {"scale": jnp.asarray(1.0)}


def init_model(key, spec: ModelSpec):
    """Returns (params, state) pytrees."""
    keys = iter(jax.random.split(key, 256))
    st = spec.stem
    params, state = {}, {}

    stem_p, stem_s = {}, {}
    if spec.quantized:
        stem_p["quant_in"] = _act_scale()
    if st.conv1_kernel is not None:
        k = st.conv1_kernel
        stem_p["conv"] = {"w": _conv_init(next(keys), k, k, spec.in_channels,
                                          spec.widths[0])}
        stem_p["bn"] = _bn_init(spec.widths[0])
        stem_s["bn"] = _bn_state(spec.widths[0])
    if st.relu1 and spec.quantized:
        stem_p["relu1"] = _act_scale()
    if spec.quantized:
        stem_p["quant_stem"] = _act_scale()
    params["stem"], state["stem"] = stem_p, stem_s

    blocks_p, blocks_s = [], []
    for indim, outdim, half in spec.block_layout():
        bp = {
            "c1": {"w": _conv_init(next(keys), 3, 3, indim, outdim)},
            "bn1": _bn_init(outdim),
            "c2": {"w": _conv_init(next(keys), 3, 3, outdim, outdim)},
            "bn2": _bn_init(outdim),
        }
        bs = {"bn1": _bn_state(outdim), "bn2": _bn_state(outdim)}
        if spec.quantized:
            bp["relu1"] = _act_scale()
            bp["relu2"] = _act_scale()
            bp["quant_out"] = _act_scale()
        if indim != outdim:
            bp["shortcut"] = {"w": _conv_init(next(keys), 1, 1, indim, outdim)}
            bp["bn_sc"] = _bn_init(outdim)
            bs["bn_sc"] = _bn_state(outdim)
            if spec.quantized:
                bp["quant_sc"] = _act_scale()
        blocks_p.append(bp)
        blocks_s.append(bs)
    params["blocks"], state["blocks"] = blocks_p, blocks_s

    head_p = {}
    if spec.quantized:
        head_p["quant_pool"] = _act_scale()
    params["head"] = head_p

    feat_dim = trunk_feat_dim(spec)
    # Classifier: torch nn.Linear default init (uniform +-1/sqrt(fan_in)),
    # bias zeroed as in reference BaselineTrain (utils.py:23).
    lim = 1.0 / math.sqrt(feat_dim)
    params["classifier"] = {
        "w": jax.random.uniform(next(keys), (feat_dim, spec.num_classes),
                                minval=-lim, maxval=lim),
        "b": jnp.zeros((spec.num_classes,)),
    }
    return params, state


# ---------------------------------------------------------------------------
# forward


def conv2d(x, w, stride=1, padding=0):
    """NHWC x HWIO conv, explicit symmetric padding (torch semantics)."""
    return jax.lax.conv_general_dilated(
        x, w,
        window_strides=(stride, stride),
        padding=((padding, padding), (padding, padding)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32,
    )


def batchnorm(x, p, s, train: bool, momentum=0.1, eps=1e-5):
    """BN over NHWC; returns (y, new_state)."""
    if train:
        mean = jnp.mean(x, axis=(0, 1, 2))
        var = jnp.var(x, axis=(0, 1, 2))
        n = x.shape[0] * x.shape[1] * x.shape[2]
        unbiased = var * n / max(n - 1, 1)
        new_s = {
            "mean": (1 - momentum) * s["mean"] + momentum * mean,
            "var": (1 - momentum) * s["var"] + momentum * unbiased,
        }
    else:
        mean, var = s["mean"], s["var"]
        new_s = s
    y = (x - mean) * jax.lax.rsqrt(var + eps) * p["gamma"] + p["beta"]
    return y, new_s


def avgpool(x, k):
    """AvgPool2d(k) with stride=k, VALID padding (torch default: drops the
    ragged border, e.g. 7x7 window on an 8x8 map -> 1x1)."""
    y = jax.lax.reduce_window(
        x, 0.0, jax.lax.add, (1, k, k, 1), (1, k, k, 1), "VALID")
    return y / (k * k)


def maxpool(x, k, stride, padding=1):
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1, k, k, 1), (1, stride, stride, 1),
        ((0, 0), (padding, padding), (padding, padding), (0, 0)))


def _qconv_w(p, spec):
    w = p["w"]
    return fake_quant_weight(w, spec.bit_width) if spec.quantized else w


def _act_q(h, node, bits, relu: bool, calib: dict | None, path: tuple):
    """Apply an activation fake-quant node; in calibration mode derive the
    scale from the running batch (Brevitas runtime-stats init) and record it.
    """
    if calib is not None:
        qmax = (2 ** bits - 1) if relu else (2 ** (bits - 1) - 1)
        ref = jnp.max(h) if relu else jnp.max(jnp.abs(h))
        scale = jnp.maximum(ref, 1e-6) / qmax
        calib[path] = scale
    else:
        scale = node["scale"]
    return (fake_quant_relu(h, scale, bits) if relu
            else fake_quant_act_signed(h, scale, bits))


def forward(params, state, x, spec: ModelSpec, train: bool = False,
            calib: dict | None = None):
    """Full model forward.

    Args:
      x: (B, S, S, C) normalized DCT (or RGB) input, NHWC.
    Returns:
      (features, logits, new_state) — mirroring BaselineTrain.forward's
      (features, scores) contract (reference utils.py:42-47).
    """
    b = spec.bit_width
    st = spec.stem
    sp, ss = params["stem"], state["stem"]
    new_state = {"stem": {}, "blocks": []}

    h = x
    if spec.quantized:
        h = _act_q(h, sp["quant_in"], b, False, calib, ("stem", "quant_in"))
    if st.conv1_kernel is not None:
        h = conv2d(h, _qconv_w(sp["conv"], spec), st.conv1_stride,
                   st.conv1_padding)
        h, nbs = batchnorm(h, sp["bn"], ss["bn"], train)
        new_state["stem"]["bn"] = nbs
    if st.relu1:
        if spec.quantized:
            h = _act_q(h, sp["relu1"], b, True, calib, ("stem", "relu1"))
        else:
            h = jax.nn.relu(h)
    if st.pool1_kernel is not None:
        h = maxpool(h, st.pool1_kernel, st.pool1_stride)
    if spec.quantized:
        h = _act_q(h, sp["quant_stem"], b, False, calib, ("stem", "quant_stem"))

    for bi, (bp, bs, (indim, outdim, half)) in enumerate(zip(
            params["blocks"], state["blocks"], spec.block_layout())):
        nbs = {}
        out = conv2d(h, _qconv_w(bp["c1"], spec), 2 if half else 1, 1)
        out, nbs["bn1"] = batchnorm(out, bp["bn1"], bs["bn1"], train)
        if spec.quantized:
            out = _act_q(out, bp["relu1"], b, True, calib, ("blocks", bi, "relu1"))
        else:
            out = jax.nn.relu(out)
        out = conv2d(out, _qconv_w(bp["c2"], spec), 1, 1)
        out, nbs["bn2"] = batchnorm(out, bp["bn2"], bs["bn2"], train)
        if spec.quantized:
            out = _act_q(out, bp["quant_out"], b, False, calib,
                         ("blocks", bi, "quant_out"))

        if indim != outdim:
            sc = conv2d(h, _qconv_w(bp["shortcut"], spec), 2 if half else 1, 0)
            sc, nbs["bn_sc"] = batchnorm(sc, bp["bn_sc"], bs["bn_sc"], train)
            if spec.quantized:
                sc = _act_q(sc, bp["quant_sc"], b, False, calib,
                            ("blocks", bi, "quant_sc"))
        else:
            sc = h

        out = out + sc
        if spec.quantized:
            h = _act_q(out, bp["relu2"], b, True, calib, ("blocks", bi, "relu2"))
        else:
            h = jax.nn.relu(out)
        new_state["blocks"].append(nbs)

    h = avgpool(h, st.avgpool_kernel)
    if spec.quantized:
        h = _act_q(h, params["head"]["quant_pool"], b, False, calib,
                   ("head", "quant_pool"))
    feats = h.reshape(h.shape[0], -1)

    logits = feats @ params["classifier"]["w"] + params["classifier"]["b"]
    return feats, logits, new_state


def calibrate_scales(params, state, x, spec: ModelSpec, train: bool = True):
    """Brevitas-style runtime-stats initialization of the activation scales.

    Runs one forward pass in which every activation quantizer derives its
    scale from the current batch statistics (progressively, so later nodes
    see already-quantized upstream activations), then returns a params
    pytree with those scales installed.  Call once on a representative
    batch before QAT training.

    ``train=True`` (default, QAT init): calibration must see batch-stats
    BatchNorm, matching the distribution the quantizers face during QAT
    training (fresh running stats would mis-scale every post-BN
    quantizer).  ``train=False`` (post-training quantization): the model
    is already trained, so calibration uses the running stats the compiled
    circuit will fold.
    """
    calib: dict = {}
    forward(params, state, x, spec, train=train, calib=calib)
    import copy
    new_params = jax.tree_util.tree_map(lambda a: a, params)  # shallow-ish
    new_params = copy.deepcopy(jax.device_get(new_params))
    for path, scale in calib.items():
        node = new_params
        for k in path:
            node = node[k]
        node["scale"] = jnp.asarray(jax.device_get(scale))
    return jax.tree_util.tree_map(jnp.asarray, new_params)


def quantize_float_model(params, state, x_calib, spec: ModelSpec,
                         n_bits: int = 5):
    """Post-training quantization of a trained FLOAT model.

    Framework equivalent of the Concrete-ML ``compile_torch_model`` input
    stage the reference uses for non-QAT checkpoints (reference
    homomorphic_eval.py:95-98, 287-295): weights are quantized per-tensor
    to ``n_bits`` and activation scales are derived from calibration-batch
    statistics, with BatchNorm in running-stats (eval) mode since the model
    is already trained.

    Returns ``(params_q, spec_q)`` — a quantized-model spec/params pair
    that the standard QAT lowering (fhe.compiler.lower) accepts.
    """
    assert not spec.quantized, "model is already QAT; compile it directly"
    spec_q = dataclasses.replace(spec, name=spec.name + "-ptq",
                                 quantized=True, bit_width=n_bits)
    skeleton, _ = init_model(jax.random.key(0), spec_q)

    def graft(skel, src):
        """Copy trained float leaves into the quantized skeleton; keep the
        skeleton's extra quantizer nodes."""
        if isinstance(skel, dict):
            return {k: (graft(v, src[k]) if k in src else v)
                    for k, v in skel.items()}
        if isinstance(skel, list):
            return [graft(sv, xv) for sv, xv in zip(skel, src)]
        return src

    merged = graft(skeleton, params)
    params_q = calibrate_scales(merged, state, x_calib, spec_q, train=False)
    return params_q, spec_q


def model_summary(spec: ModelSpec, params=None) -> str:
    """Per-layer topology/parameter table — the framework's analog of the
    reference's ``torchinfo.summary`` dump (reference train.py:335-347).

    Walks the spec (no forward pass needed): one row per layer with output
    shape and parameter count; total at the bottom.  With ``params`` the
    counts come from the actual pytree leaves, otherwise from the spec.
    """
    st = spec.stem
    rows = []
    H = spec.img_size

    def n_params(*shapes):
        return sum(int(np.prod(s)) for s in shapes)

    oh = (H + 2 * st.conv1_padding - st.conv1_kernel) // st.conv1_stride + 1
    w0 = spec.widths[0]
    rows.append((f"stem conv {st.conv1_kernel}x{st.conv1_kernel}"
                 f"/s{st.conv1_stride}",
                 (oh, oh, w0),
                 n_params((st.conv1_kernel, st.conv1_kernel,
                           spec.in_channels, w0))))
    rows.append(("stem bn", (oh, oh, w0), n_params((w0,), (w0,))))
    if st.relu1:
        rows.append(("stem relu (quant)", (oh, oh, w0), 0))
    if st.pool1_kernel is not None:
        oh = (oh + 2 * 1 - st.pool1_kernel) // st.pool1_stride + 1
        rows.append((f"maxpool {st.pool1_kernel}x{st.pool1_kernel}"
                     f"/s{st.pool1_stride}", (oh, oh, w0), 0))
    for i, (indim, outdim, half) in enumerate(spec.block_layout()):
        stride = 2 if half else 1
        oh = (oh + 2 - 3) // stride + 1
        p = (n_params((3, 3, indim, outdim), (outdim,), (outdim,),
                      (3, 3, outdim, outdim), (outdim,), (outdim,)))
        if indim != outdim:
            p += n_params((1, 1, indim, outdim), (outdim,), (outdim,))
        tag = f"block{i} {indim}->{outdim}" + ("/s2" if half else "")
        if indim != outdim:
            tag += " +shortcut"
        rows.append((tag, (oh, oh, outdim), p))
    kp = st.avgpool_kernel
    oh_p = oh // kp
    F = oh_p * oh_p * spec.widths[-1]
    rows.append((f"avgpool {kp}x{kp} + flatten", (F,), 0))
    rows.append(("classifier (clear)", (spec.num_classes,),
                 n_params((F, spec.num_classes), (spec.num_classes,))))

    if params is not None:
        total = sum(int(np.prod(np.shape(leaf)))
                    for leaf in jax.tree_util.tree_leaves(params))
    else:
        total = sum(r[2] for r in rows)
    name_w = max(len(r[0]) for r in rows) + 2
    lines = [f"{spec.name}: input {spec.in_channels}x{spec.img_size}^2, "
             f"bit_width {spec.bit_width}, "
             f"{'QAT' if spec.quantized else 'float'}"]
    lines += [f"  {r[0]:<{name_w}} out={'x'.join(map(str, r[1])):<12} "
              f"params={r[2]:,}" for r in rows]
    lines.append(f"  total params: {total:,}"
                 + (" (from param pytree)" if params is not None else ""))
    return "\n".join(lines)
