"""Worker process for the multi-host (multi-process) CPU-mesh test.

Each process models one HOST of a pod slice: its own jax runtime with
4 virtual CPU devices (the host's "chips"), joined through
``jax.distributed`` over a local coordinator.  Runs one data-parallel
sharded train step over the ('host', 'chip') mesh and one sharded
encrypted bootstrap batch with replicated server keys, then writes its
results for the parent to assert on.

Usage: python multihost_worker.py <coordinator> <num_procs> <pid> <outdir>
"""
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    coord, n_proc, pid, outdir = (sys.argv[1], int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4])
    from dct_cryptonets.parallel import (host_chip_mesh, initialize,
                                             local_batch_to_global,
                                             replicate)
    initialize(coordinator_address=coord, num_processes=n_proc,
               process_id=pid)
    assert jax.process_count() == n_proc
    assert len(jax.devices()) == 4 * n_proc     # global view
    mesh = host_chip_mesh()
    assert mesh.devices.shape == (n_proc, 4)

    # ---- one sharded train step (gradients all-reduced across hosts)
    import argparse
    from dct_cryptonets.data import CodecConfig
    from dct_cryptonets.models import build_spec, init_model
    from dct_cryptonets.train import make_optimizer, make_steps

    cfg = argparse.Namespace(optimizer="adam", weight_decay=1e-5,
                             momentum=0.9, grad_clip_value=None,
                             grad_clip_norm=None, train_aug=False)
    codec_cfg = CodecConfig(channels=24, filter_size=4, image_size_dct=16)
    spec = build_spec("ResNet20qat", in_channels=24, img_size=16,
                      num_classes=10, bit_width=4)
    params, state = init_model(jax.random.key(0), spec)
    opt = make_optimizer(cfg, 1e-3)
    opt_state = opt.init(params)
    train_step, _ = make_steps(spec, cfg, codec_cfg, opt, None)

    params = replicate(mesh, params)
    state = replicate(mesh, state)
    opt_state = replicate(mesh, opt_state)

    # per-host local batch: 4 samples (1 per local device); ALL processes
    # use the same global data so the resulting loss is deterministic and
    # identical across hosts (the parent asserts equality)
    rng = np.random.default_rng(0)
    g_images = rng.integers(0, 256, (4 * n_proc, 32, 32, 3)).astype(np.uint8)
    g_labels = rng.integers(0, 10, 4 * n_proc).astype(np.int32)
    lo = 4 * pid
    images = local_batch_to_global(mesh, g_images[lo:lo + 4])
    labels = local_batch_to_global(mesh, g_labels[lo:lo + 4])

    from jax.sharding import NamedSharding, PartitionSpec as P
    # device_put of a typed PRNG key array rejects non-addressable
    # (multi-process) shardings; replicate the raw key data and re-wrap
    kd = jax.device_put(jax.random.key_data(jax.random.key(7)),
                        NamedSharding(mesh, P()))
    key = jax.random.wrap_key_data(kd)
    params, state, opt_state, loss, logits = train_step(
        params, state, opt_state, key, images, labels)
    loss_val = float(loss)
    assert np.isfinite(loss_val)

    # ---- one sharded encrypted batch: ciphertexts shard over the global
    # mesh, server keys replicate (the one-time broadcast), results decrypt
    # correctly on every host
    from dct_cryptonets.fhe import keys as K
    from dct_cryptonets.fhe import pbs as PB
    from dct_cryptonets.fhe import torus as T
    from dct_cryptonets.fhe.params import TEST_PARAMS

    ck = K.keygen(TEST_PARAMS, seed=0)
    sk = K.make_server_keys(ck, seed=1)
    dsk = PB.preprocess_server_keys(sk)
    bits = 3
    M = 4 * n_proc
    msgs = np.arange(M) % (2 ** bits)
    mu = msgs.astype(np.uint64) << np.uint64(64 - bits - 1)
    ct_np = K.encrypt_lwe(ck, mu, K.Csprng(2), key=ck.big_lwe_key,
                          noise_log2=TEST_PARAMS.glwe_noise_log2)
    tables = np.tile(np.arange(2 ** bits, dtype=np.int32), (M, 1))

    ct_t = T.from_u64(ct_np)
    lo_ct = T.T64(*local_batch_to_global(
        mesh, [np.asarray(ct_t.hi)[lo:lo + 4], np.asarray(ct_t.lo)[lo:lo + 4]]))
    tab_g = local_batch_to_global(mesh, tables[lo:lo + 4])
    dsk_rep = PB.DeviceServerKeys(*replicate(mesh, list(dsk)))
    out = PB.bootstrap(lo_ct, tab_g, dsk_rep, TEST_PARAMS,
                       out_delta_log2=64 - bits - 1)
    # gather this host's shards and decrypt
    hi = np.concatenate([np.asarray(s.data) for s in out.hi.addressable_shards])
    lo64 = np.concatenate([np.asarray(s.data)
                           for s in out.lo.addressable_shards])
    phase = K.decrypt_lwe(ck, T.to_u64(T.T64(jnp.asarray(hi),
                                             jnp.asarray(lo64))),
                          key=ck.big_lwe_key)
    shift = np.uint64(64 - bits - 1)
    half = np.uint64(1) << (shift - np.uint64(1))
    with np.errstate(over="ignore"):
        dec = ((phase + half) >> shift) & np.uint64((1 << (bits + 1)) - 1)
    want = msgs[lo:lo + 4]
    assert np.array_equal(dec, want), (dec, want)

    with open(os.path.join(outdir, f"proc{pid}.ok"), "w") as fh:
        fh.write(f"{loss_val:.6f}\n")
    print(f"proc {pid}: loss={loss_val:.6f} encrypted-batch ok")


if __name__ == "__main__":
    main()
