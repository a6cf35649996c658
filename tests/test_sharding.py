"""Multi-device sharding tests on the virtual 8-device CPU mesh."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dct_cryptonets.parallel import data_mesh, replicate, shard_batch


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


@pytest.mark.slow
def test_dryrun_multichip_entrypoint():
    """The driver-facing dry run: full sharded training step on 8 devices."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__",
        os.path.join(os.path.dirname(__file__), "..", "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8)


def test_entry_compiles():
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__",
        os.path.join(os.path.dirname(__file__), "..", "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    logits = jax.jit(fn)(*args)
    assert logits.shape[-1] == 10
    assert np.isfinite(np.asarray(logits)).all()


def test_shard_batch_places_on_devices():
    mesh = data_mesh(8)
    x = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    xs = shard_batch(mesh, x)
    assert len(xs.sharding.device_set) == 8
    np.testing.assert_array_equal(np.asarray(xs), x)
    r = replicate(mesh, {"a": np.ones(3)})
    assert len(r["a"].sharding.device_set) == 8


def test_sharded_pbs_batch():
    """Ciphertext batches are embarrassingly parallel: a sharded bootstrap
    call must produce the same results as the unsharded one."""
    from dct_cryptonets.fhe import torus as T
    from dct_cryptonets.fhe import pbs as P
    from dct_cryptonets.fhe import keys as K
    from dct_cryptonets.fhe.params import TEST_PARAMS

    ck = K.keygen(TEST_PARAMS, seed=0)
    sk = K.make_server_keys(ck, seed=1)
    dsk = P.preprocess_server_keys(sk)
    rng = np.random.default_rng(2)
    bits = 3
    M = 16
    msgs = rng.integers(0, 2 ** bits, M)
    mu = msgs.astype(np.uint64) << np.uint64(64 - bits - 1)
    ct_np = K.encrypt_lwe(ck, mu, rng, key=ck.big_lwe_key,
                          noise_log2=TEST_PARAMS.glwe_noise_log2)
    tables = np.tile(np.arange(2 ** bits, dtype=np.int32), (M, 1))

    mesh = data_mesh(8)
    ct_sharded = T.T64(*shard_batch(mesh, list(T.from_u64(ct_np))))
    tab_sharded = shard_batch(mesh, jnp.asarray(tables))
    dsk_rep = P.DeviceServerKeys(*replicate(mesh, list(dsk)))

    out = P.bootstrap(ct_sharded, tab_sharded, dsk_rep, TEST_PARAMS,
                      out_delta_log2=64 - bits - 1)
    phase = K.decrypt_lwe(ck, T.to_u64(out), key=ck.big_lwe_key)
    shift = np.uint64(64 - bits - 1)
    half = np.uint64(1) << (shift - np.uint64(1))
    with np.errstate(over="ignore"):
        dec = ((phase + half) >> shift) & np.uint64((1 << (bits + 1)) - 1)
    np.testing.assert_array_equal(dec, msgs)


@pytest.mark.slow
def test_module_level_sharded_execute():
    """CompiledModule.forward(fhe='execute', mesh=...) with replicated keys
    and a sharded ciphertext batch matches the unsharded run bit-exactly."""
    import jax
    from dct_cryptonets.models import init_model, calibrate_scales
    from dct_cryptonets.models.resnet import ModelSpec, forward
    from dct_cryptonets.models.topology import StemSpec
    from dct_cryptonets.fhe.runtime import compile_qat_model
    from dct_cryptonets.fhe.params import TEST_PARAMS

    tiny = ModelSpec(
        name="tinyqat", block_counts=(1,), widths=(4,), in_channels=3,
        img_size=4, num_classes=4, bit_width=3, quantized=True,
        stem_override=StemSpec(1, 1, 0, None, None, 4, relu1=True),
    )
    params, state = init_model(jax.random.key(0), tiny)
    x = jax.random.normal(jax.random.key(1), (8, 4, 4, 3))
    for _ in range(2):
        _, _, state = forward(params, state, x, tiny, train=True)
    params = calibrate_scales(params, state, x, tiny)

    xq = np.clip(np.random.default_rng(5).normal(0, 0.7, (8, 4, 4, 3)),
                 -2, 2).astype(np.float32)
    module = compile_qat_model(params, state, tiny, n_bits=3,
                               rounding_threshold_bits=8,
                               calib_absmax=2.0, tfhe_params=TEST_PARAMS,
                               pbs_batch=512)
    module.keygen(seed=6)
    from dct_cryptonets.fhe.keys import Csprng
    # identical masks for both runs: the sharded-vs-unsharded contract is
    # about the SERVER computation, so fix the client encryption stream
    ref = module.forward(xq, fhe="execute", enc_rng=Csprng(7))
    # reference for the remainder case below: the mesh path pads 5 -> 8 by
    # repeating the last sample, so the unsharded reference runs the SAME
    # padded batch (identical Csprng stream -> identical ciphertexts)
    xr = xq[:5]
    xr_pad = np.concatenate([xr, np.repeat(xr[-1:], 3, axis=0)], axis=0)
    ref_r = module.forward(xr_pad, fhe="execute", enc_rng=Csprng(9))[:5]

    mesh = data_mesh(8)
    module.shard_over(mesh)
    got = module.forward(xq, fhe="execute", mesh=mesh, enc_rng=Csprng(7))
    np.testing.assert_array_equal(got, ref)

    # remainder batch (size not divisible by the mesh): forward pads the
    # batch internally and trims the result — previously shard_batch's
    # NamedSharding device_put raised, crashing a sweep at its last batch
    got_r = module.forward(xr, fhe="execute", mesh=mesh, enc_rng=Csprng(9))
    assert got_r.shape == ref_r.shape
    np.testing.assert_array_equal(got_r, ref_r)
