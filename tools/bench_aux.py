#!/usr/bin/env python
"""Measure the exact-rounding aux extraction throughput on the device.

One extraction = one clear_low_bits bit step: forward keyswitch from the
main big key into the aux small set, mod switch, N_aux blind rotate,
sample extract, back keyswitch, subtract.  This is the dominant cost of
exact-rounding (Concrete-default) encrypted inference, so the bench's
image-latency estimate should use the MEASURED rate, not the n*N^2 model.

Env: BENCH_M (default 2048), BENCH_SHIFT (bits cleared per call, default 4),
     BENCH_AUX_DROP (default 3), BENCH_AUX_CROSS (default 0),
     BENCH_EXTRACT (extraction preset name from params.EXTRACT_PRESETS,
     default params.DEFAULT_EXTRACT).
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax.numpy as jnp
    from dct_cryptonets.fhe import torus as T
    from dct_cryptonets.fhe.keys import (encrypt_lwe, keygen,
                                             make_aux_server_keys)
    from dct_cryptonets.fhe.params import (default_exact_rounding,
                                               params_for_precision)
    from dct_cryptonets.fhe.pbs import clear_low_bits, preprocess_aux_keys

    M = int(os.environ.get("BENCH_M", 2048))
    shift = int(os.environ.get("BENCH_SHIFT", 4))
    params = params_for_precision(6)
    cfg = default_exact_rounding(
        params, extract=os.environ.get("BENCH_EXTRACT") or None)
    drop = int(os.environ.get("BENCH_AUX_DROP", 3))
    cross = int(os.environ.get("BENCH_AUX_CROSS", 0))
    n_in = 13
    print(f"# aux set: n={cfg.aux.lwe_dim} k={cfg.aux.glwe_dim} "
          f"N={cfg.aux.poly_size} drop={drop} cross={cross}",
          file=sys.stderr)

    cache = (f".cache/bench_aux_keys_n{cfg.aux.lwe_dim}"
             f"_k{cfg.aux.glwe_dim}"
             f"_N{cfg.aux.poly_size}_b{cfg.aux.pbs_base_log}.npz")
    os.makedirs(".cache", exist_ok=True)
    ck = keygen(params, seed=0)
    if os.path.exists(cache):
        z = np.load(cache)
        from dct_cryptonets.fhe.keys import AuxServerKeyMaterial
        ak = AuxServerKeyMaterial(cfg.aux, cfg.back_base_log,
                                  cfg.back_levels, z["bsk"], z["ksk_fwd"],
                                  z["ksk_back"])
    else:
        t = time.time()
        ak = make_aux_server_keys(ck, cfg.aux, seed=2,
                                  back_base_log=cfg.back_base_log,
                                  back_levels=cfg.back_levels)
        print(f"# aux keygen {time.time()-t:.1f}s", file=sys.stderr)
        np.savez_compressed(cache, bsk=ak.bsk, ksk_fwd=ak.ksk_fwd,
                            ksk_back=ak.ksk_back)
    dak = preprocess_aux_keys(ak)

    rng = np.random.default_rng(3)
    v = rng.integers(0, 2 ** n_in, M).astype(np.uint64)
    mu = v << np.uint64(63 - n_in)
    ct = T.from_u64(encrypt_lwe(ck, mu, rng, key=ck.big_lwe_key,
                                noise_log2=params.glwe_noise_log2))

    def run(c):
        return clear_low_bits(c, dak, cfg.aux, n_in, shift,
                              cfg.back_base_log, cfg.back_levels,
                              drop_limbs=drop, cross=cross)

    t0 = time.time()
    out = run(ct)
    _ = int(np.asarray(out.hi[0, 0]))
    print(f"# compile+first {time.time()-t0:.1f}s", file=sys.stderr)

    iters = 3
    t0 = time.time()
    cur = ct
    for _ in range(iters):
        cur = run(cur)   # chained: output is a valid same-shape ciphertext
    _ = int(np.asarray(cur.hi[0, 0]))
    dt = (time.time() - t0) / iters
    rate = M * shift / dt
    print(f"# {dt:.2f}s per {M}x{shift} extraction batch "
          f"(drop={drop}) -> {rate:.1f} extractions/s")
    print(f"# ratio vs one main PBS: "
          f"{rate and (1.0 / rate):.6f}s each", file=sys.stderr)


if __name__ == "__main__":
    main()
