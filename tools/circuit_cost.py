#!/usr/bin/env python
"""Analyze a compiled circuit's PBS cost structure.

For every TLU layer: sites/sample, accumulator budget n, table bits r_eff,
shift (= aux extraction bootstraps per site in exact-rounding mode), and the
blind-rotate work in normalized main-PBS units (cost ~ n_lwe * N^2 at equal
gadget settings).  Prints totals for both rounding methods so the bench's
image-latency estimates can include the true exact-mode overhead (the
reference's Concrete default is the exact method; its 565 s/image includes
the analogous per-bit clearing cost — reference homomorphic_eval.py:276-285).

Usage:  python tools/circuit_cost.py [--calib] [--rounding R]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--calib", action="store_true",
                    help="use calibration-based accumulator budgets")
    ap.add_argument("--rounding", type=int, default=6)
    ap.add_argument("--model", default="ResNet20qat")
    ap.add_argument("--channels", type=int, default=24)
    ap.add_argument("--img", type=int, default=16)
    args = ap.parse_args()

    import numpy as np
    import jax
    import jax.numpy as jnp
    from dct_cryptonets.data import CodecConfig, dct_ingest
    from dct_cryptonets.data.pipeline import load_synthetic
    from dct_cryptonets.models import (build_spec, calibrate_scales,
                                           forward, init_model)
    from dct_cryptonets.fhe.compiler import lower
    from dct_cryptonets.fhe.circuit import Tlu
    from dct_cryptonets.fhe.params import (default_exact_rounding,
                                               params_for_precision)

    cfg = CodecConfig(channels=args.channels, filter_size=4,
                      image_size_dct=args.img)
    spec = build_spec(args.model, in_channels=args.channels,
                      img_size=args.img, num_classes=10, bit_width=4)
    params, state = init_model(jax.random.key(0), spec)
    ds = load_synthetic(64, 64, 10, seed=0)
    x = dct_ingest(jnp.asarray(ds.images), cfg)
    params = calibrate_scales(params, state, x, spec)
    _, _, state = forward(params, state, x, spec, train=True)
    circ = lower(params, state, spec,
                 rounding_threshold_bits=args.rounding,
                 calib_data=x if args.calib else None)

    max_r = max(op.spec.in_bits for op in circ.ops if isinstance(op, Tlu))
    main = params_for_precision(max_r)
    aux = default_exact_rounding(main).aux
    # blind-rotate work ~ n * N^2 (same gadget levels); 1.0 = one main PBS
    aux_unit = (aux.lwe_dim * aux.poly_size ** 2) / (
        main.lwe_dim * main.poly_size ** 2)

    shapes = circ.meta["shapes"]
    print(f"{'tensor':<10} {'sites':>8} {'n':>3} {'r':>2} {'shift':>5} "
          f"{'mainPBS':>9} {'auxPBS':>9}")
    tot_sites = tot_aux = 0
    for op in circ.ops:
        if not isinstance(op, Tlu):
            continue
        sites = int(np.prod(shapes[op.x]))
        n_in = op.spec.in_bits + op.spec.shift
        aux_n = sites * op.spec.shift
        tot_sites += sites
        tot_aux += aux_n
        print(f"{op.x:<10} {sites:>8} {n_in:>3} {op.spec.in_bits:>2} "
              f"{op.spec.shift:>5} {sites:>9} {aux_n:>9}")

    eq_exact = tot_sites + tot_aux * aux_unit
    print(f"\nmain set: n={main.lwe_dim} N={main.poly_size}; "
          f"aux set: n={aux.lwe_dim} N={aux.poly_size} "
          f"(aux BR work = {aux_unit:.3f} main-PBS units)")
    print(f"max acc bit-width: {circ.max_bit_width()} (<=16 required)")
    print(f"PBS/image (main TLUs):            {tot_sites:>10}")
    print(f"aux extraction bootstraps/image:  {tot_aux:>10}")
    print(f"approximate-mode cost (main-PBS units): {tot_sites:>12.0f}")
    print(f"exact-mode cost       (main-PBS units): {eq_exact:>12.0f} "
          f"({eq_exact / tot_sites:.2f}x)")


if __name__ == "__main__":
    main()
