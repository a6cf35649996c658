"""Statistical fault model (p_error injection) tests."""
import numpy as np
import jax
import jax.numpy as jnp

from dct_cryptonets.fhe.circuit import simulate, simulate_noisy
from dct_cryptonets.fhe.compiler import lower


def _tiny():
    from tests.test_fhe_e2e import TINY
    from dct_cryptonets.models import init_model, forward, calibrate_scales
    params, state = init_model(jax.random.key(0), TINY)
    x8 = jax.random.normal(jax.random.key(1), (8, 4, 4, 3))
    _, _, state = forward(params, state, x8, TINY, train=True)
    params = calibrate_scales(params, state, x8, TINY)
    return lower(params, state, TINY, rounding_threshold_bits=4)


def test_zero_slip_matches_simulate():
    circ = _tiny()
    x = jnp.asarray(np.random.default_rng(0).normal(0, 0.7, (4, 4, 4, 3)),
                    jnp.float32)
    a = simulate(circ, x)
    b = simulate_noisy(circ, x, jax.random.key(2), 0.0)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_small_slip_small_perturbation():
    circ = _tiny()
    x = jnp.asarray(np.random.default_rng(0).normal(0, 0.7, (8, 4, 4, 3)),
                    jnp.float32)
    clean = np.asarray(simulate(circ, x))
    noisy = np.asarray(simulate_noisy(circ, x, jax.random.key(3), 0.01))
    # outputs perturbed but correlated
    denom = np.abs(clean).mean() + 1e-6
    rel = np.abs(noisy - clean).mean() / denom
    assert rel < 0.5, rel
    heavy = np.asarray(simulate_noisy(circ, x, jax.random.key(3), 0.5))
    rel_heavy = np.abs(heavy - clean).mean() / denom
    assert rel_heavy > rel
