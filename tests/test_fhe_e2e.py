"""End-to-end FHE tests: compile tiny QAT model -> simulate == execute.

This is the framework's core contract: decrypted
logits from the encrypted runtime must match the integer simulator
bit-exactly (the simulator in turn stands in for Concrete's
``fhe='simulate'`` oracle, reference homomorphic_eval.py:333-347).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dct_cryptonets.models import init_model
from dct_cryptonets.models.resnet import ModelSpec, forward
from dct_cryptonets.models.topology import StemSpec
from dct_cryptonets.fhe import torus as T
from dct_cryptonets.fhe.params import TEST_PARAMS
from dct_cryptonets.fhe.compiler import lower
from dct_cryptonets.fhe.circuit import Tlu, simulate
from dct_cryptonets.fhe.runtime import compile_qat_model


TINY = ModelSpec(
    name="tinyqat", block_counts=(1,), widths=(4,), in_channels=3,
    img_size=4, num_classes=4, bit_width=3, quantized=True,
    stem_override=StemSpec(1, 1, 0, None, None, 4, relu1=True),
)


@pytest.fixture(scope="module")
def tiny_model():
    from dct_cryptonets.models import calibrate_scales
    params, state = init_model(jax.random.key(0), TINY)
    # run a couple of train-mode forwards so BN state is non-trivial
    x = jax.random.normal(jax.random.key(1), (8, 4, 4, 3))
    for _ in range(2):
        _, _, state = forward(params, state, x, TINY, train=True)
    # runtime-stats scale calibration (Brevitas-style init)
    params = calibrate_scales(params, state, x, TINY)
    return params, state


def test_lower_structure(tiny_model):
    params, state = tiny_model
    circ = lower(params, state, TINY, n_bits=3, rounding_threshold_bits=3,
                 calib_absmax=2.0, residual_mode="requant")
    tlus = [op for op in circ.ops if isinstance(op, Tlu)]
    # stem TLU, relu1, quant_out, relu2, pool TLU (identity shortcut: no TLU)
    assert len(tlus) == 5
    assert circ.max_bit_width() <= 16
    assert circ.num_pbs == 4 * 4 * 4 * 4 + 4  # 4 spatial TLUs + pooled head
    for op in tlus:
        assert op.spec.in_bits <= 3
        assert op.table.shape[1] == 1 << op.spec.in_bits


def test_lower_structure_fused(tiny_model):
    """residual_mode='fused' (default): the quant_out requant TLU is elided
    — the raw conv2 accumulator feeds the residual add through per-channel
    multipliers and relu2's table absorbs scale + bias."""
    from dct_cryptonets.fhe.circuit import AddScaledPC
    params, state = tiny_model
    circ = lower(params, state, TINY, n_bits=3, rounding_threshold_bits=3,
                 calib_absmax=2.0)
    tlus = [op for op in circ.ops if isinstance(op, Tlu)]
    assert len(tlus) == 4                      # stem, relu1, relu2, pool
    assert circ.num_pbs == 3 * 4 * 4 * 4 + 4   # one fewer spatial TLU layer
    pc = [op for op in circ.ops if isinstance(op, AddScaledPC)]
    assert len(pc) == 1
    assert circ.verify_encodings() == []
    assert circ.max_bit_width() <= 16


def test_simulator_matches_qat_forward_exactly_without_rounding(tiny_model):
    """With rounding disabled (r >= max accumulator bits) the integer
    simulator must reproduce the fake-quant QAT forward EXACTLY — BN fold,
    TLU fusion, residual rescaling and all."""
    params, state = tiny_model
    circ = lower(params, state, TINY, rounding_threshold_bits=14,
                 residual_mode="requant")
    x = np.clip(np.random.default_rng(2).normal(0, 0.7, (16, 4, 4, 3)), -2, 2)
    feats_sim = np.asarray(simulate(circ, jnp.asarray(x, jnp.float32)))
    feats_qat, _, _ = forward(params, state, jnp.asarray(x, jnp.float32),
                              TINY, train=False)
    np.testing.assert_allclose(feats_sim, np.asarray(feats_qat), atol=1e-5)


def test_fused_mode_tracks_qat_forward(tiny_model):
    """The requant-elided graph is NOT the literal fake-quant forward (it
    keeps full accumulator resolution into the residual add), but it must
    stay within the elided requant's own rounding error of it."""
    params, state = tiny_model
    circ = lower(params, state, TINY, rounding_threshold_bits=14)
    x = np.clip(np.random.default_rng(2).normal(0, 0.7, (16, 4, 4, 3)), -2, 2)
    feats_sim = np.asarray(simulate(circ, jnp.asarray(x, jnp.float32)))
    feats_qat, _, _ = forward(params, state, jnp.asarray(x, jnp.float32),
                              TINY, train=False)
    out_op = circ.ops[-1]
    # bounded by a few output quantization steps (the elided quant_out
    # rounding propagated through relu2's table)
    assert np.abs(feats_sim - np.asarray(feats_qat)).max() <= 4 * out_op.scale
    a, b = feats_sim.ravel(), np.asarray(feats_qat).ravel()
    # a random 3-bit toy net quantizes to a handful of levels, so +-1-step
    # flips near rounding boundaries are common — correlation is a sanity
    # floor here; end-to-end accuracy parity of fused vs requant is
    # validated on the trained digits model (tools/digits_fused_parity.py)
    assert np.corrcoef(a, b)[0, 1] > 0.6


def test_simulator_rounding_degrades_gracefully(tiny_model):
    """Accumulator rounding (rounding_threshold_bits) is an approximation;
    at r=6 the toy net should stay correlated with the exact forward."""
    params, state = tiny_model
    circ = lower(params, state, TINY, rounding_threshold_bits=6)
    x = np.clip(np.random.default_rng(2).normal(0, 0.7, (16, 4, 4, 3)), -2, 2)
    feats_sim = np.asarray(simulate(circ, jnp.asarray(x, jnp.float32)))
    feats_qat, _, _ = forward(params, state, jnp.asarray(x, jnp.float32),
                              TINY, train=False)
    a, b = feats_sim.ravel(), np.asarray(feats_qat).ravel()
    corr = np.corrcoef(a, b)[0, 1]
    assert corr > 0.5, corr


def test_execute_matches_simulate_bit_exact(tiny_model):
    """The headline contract: encrypted execution == integer simulation.

    Deliberately in the FAST tier (~60 s warm via the persistent compile
    cache): a default ``-m "not slow"`` CI run must execute at least one
    full encrypt -> encrypted-eval -> decrypt path end-to-end."""
    params, state = tiny_model
    module = compile_qat_model(
        params, state, TINY, n_bits=3, rounding_threshold_bits=3,
        calib_absmax=2.0, tfhe_params=TEST_PARAMS, pbs_batch=512)
    module.keygen(seed=5)

    x = np.clip(np.random.default_rng(3).normal(0, 0.7, (1, 4, 4, 3)), -2, 2)
    feats_sim = module.forward(x.astype(np.float32), fhe="simulate")
    feats_exe = module.forward(x.astype(np.float32), fhe="execute")
    np.testing.assert_array_equal(feats_exe, feats_sim)


def test_realized_slip_audit_zero_under_bit_exact_contract(tiny_model):
    """run_encrypted(check_ref=...) decrypts every TLU output and counts
    mismatches vs the clear simulator (the realized-slip audit of
    ``--slip_audit``).  Under drop_policy='none' the bit-exact
    contract holds, so the realized slip count must be exactly zero and
    the realigned execute output must still equal the simulator's."""
    params, state = tiny_model
    module = compile_qat_model(
        params, state, TINY, n_bits=3, rounding_threshold_bits=3,
        calib_absmax=2.0, tfhe_params=TEST_PARAMS, pbs_batch=512)
    module.keygen(seed=7)

    x = np.clip(np.random.default_rng(5).normal(0, 0.7, (1, 4, 4, 3)), -2, 2)
    x = x.astype(np.float32)
    feats_sim, env = simulate(module.circuit, jnp.asarray(x),
                              return_env=True)
    ct = module.encrypt(x)
    out = module.run_encrypted(ct, check_ref={
        k: np.asarray(v) for k, v in env.items()})
    np.testing.assert_array_equal(module.decrypt_feats(out),
                                  np.asarray(feats_sim))
    assert module.stats["tlu_slips"] == 0
    assert module.stats["tlu_sites"] == module.circuit.num_pbs
    assert all(d[1] == 0 for d in module.stats["tlu_slip_detail"])


@pytest.mark.slow
def test_fs8_ingest_execute_matches_simulate():
    """ResNet-18-style fs=8 evidence: real libjpeg-path DCT ingest (the
    ResNet-18 codec config, 6 channels at filter 8) feeding a
    '64_6_32'-shaped stem (1x1 conv, no relu1) + residual block, compiled
    and EXECUTED == simulated bit-exactly (reference README.md:88 row;
    topology per run_homomorphic_eval.sh's ResNet-18 CIFAR preset)."""
    from dct_cryptonets.data.codec import CodecConfig, dct_ingest
    from dct_cryptonets.models import calibrate_scales

    cfg = CodecConfig(channels=6, filter_size=8, image_size_dct=4)
    rng = np.random.default_rng(9)
    imgs = jnp.asarray(rng.integers(0, 256, (8, 40, 40, 3), np.uint8))
    x = np.asarray(dct_ingest(imgs, cfg))
    assert x.shape == (8, 4, 4, 6)

    # stem mirrors the reference's '64_6_32' entry (1x1/s1/p0 conv, no
    # relu1) at test width; one residual block behind it
    spec = ModelSpec(name="fs8stemqat", block_counts=(1,), widths=(8,),
                     in_channels=6, img_size=4, num_classes=4, bit_width=3,
                     quantized=True,
                     stem_override=StemSpec(1, 1, 0, None, None, 4,
                                            relu1=False))
    params, state = init_model(jax.random.key(8), spec)
    for _ in range(2):
        _, _, state = forward(params, state, jnp.asarray(x), spec,
                              train=True)
    params = calibrate_scales(params, state, jnp.asarray(x), spec)
    module = compile_qat_model(
        params, state, spec, n_bits=3, rounding_threshold_bits=4,
        calib_data=x, tfhe_params=TEST_PARAMS, pbs_batch=512)
    module.keygen(seed=9)
    feats_sim = module.forward(x[:1], fhe="simulate")
    feats_exe = module.forward(x[:1], fhe="execute")
    np.testing.assert_array_equal(feats_exe, feats_sim)


def test_chunked_scan_path_matches_simulate(tiny_model):
    """A tiny pbs_batch/aux_batch forces the single-dispatch scan path
    (pbs.bootstrap_chunked / clear_low_bits_chunked) with a non-multiple
    site count, exercising the zero-ciphertext padding: execute must
    still equal the simulator bit-exactly."""
    params, state = tiny_model
    module = compile_qat_model(
        params, state, TINY, n_bits=3, rounding_threshold_bits=3,
        calib_absmax=2.0, tfhe_params=TEST_PARAMS, pbs_batch=16)
    module.aux_batch = 16
    module.keygen(seed=11)
    # 68 spatial sites per TLU layer -> 5 chunks of 16 with 12 padded
    x = np.clip(np.random.default_rng(13).normal(0, 0.7, (1, 4, 4, 3)), -2, 2)
    feats_sim = module.forward(x.astype(np.float32), fhe="simulate")
    feats_exe = module.forward(x.astype(np.float32), fhe="execute")
    np.testing.assert_array_equal(feats_exe, feats_sim)


def test_balanced_bytes_roundtrip():
    rng = np.random.default_rng(11)
    x = rng.integers(0, 1 << 63, (257,), dtype=np.int64).astype(np.uint64)
    x = (x << np.uint64(1)) | rng.integers(0, 2, (257,)).astype(np.uint64)
    t = T.from_u64(x)
    bb = T.balanced_bytes(t)
    assert bb.shape == (8, 257) and bb.dtype == jnp.int8
    back = T.to_u64(T.from_balanced_bytes(bb))
    np.testing.assert_array_equal(back, x)


# two-stage net: the stage-transition shortcut conv shares its input with
# the wider 3x3 conv1 path, so its accumulator arrives encoded wider than
# its own budget and the compiler must insert a phase-only Rescale
# (regression for the shared-tensor encoding-inflation bug)
TINY2 = ModelSpec(
    name="tiny2qat", block_counts=(1, 1), widths=(4, 8), in_channels=3,
    img_size=4, num_classes=4, bit_width=3, quantized=True,
    stem_override=StemSpec(1, 1, 0, None, None, 2, relu1=True),
)


@pytest.mark.slow
def test_rescale_execute_matches_simulate():
    from dct_cryptonets.models import calibrate_scales
    from dct_cryptonets.fhe.circuit import Rescale

    params, state = init_model(jax.random.key(4), TINY2)
    x = jax.random.normal(jax.random.key(5), (8, 4, 4, 3))
    for _ in range(2):
        _, _, state = forward(params, state, x, TINY2, train=True)
    params = calibrate_scales(params, state, x, TINY2)

    module = compile_qat_model(
        params, state, TINY2, n_bits=3, rounding_threshold_bits=3,
        calib_absmax=2.0, tfhe_params=TEST_PARAMS, pbs_batch=512)
    assert module.circuit.verify_encodings() == []
    rescales = [op for op in module.circuit.ops if isinstance(op, Rescale)]
    assert rescales, "expected the shortcut-conv TLU to need a Rescale"
    module.keygen(seed=6)

    xin = np.clip(np.random.default_rng(7).normal(0, 0.7, (1, 4, 4, 3)), -2, 2)
    feats_sim = module.forward(xin.astype(np.float32), fhe="simulate")
    feats_exe = module.forward(xin.astype(np.float32), fhe="execute")
    np.testing.assert_array_equal(feats_exe, feats_sim)
