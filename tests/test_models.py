"""Model topology + forward tests (parity with reference backbone shapes)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dct_cryptonets.models import build_spec, init_model, forward


@pytest.mark.parametrize("name,in_ch,img,feat", [
    ("ResNet20qat", 24, 16, 64),   # primary CIFAR DCT config
    ("ResNet20", 24, 16, 64),
    ("ResNet18qat", 64, 56, 512),  # ImageNet DCT config
])
def test_forward_shapes(name, in_ch, img, feat):
    spec = build_spec(name, in_channels=in_ch, img_size=img, num_classes=10)
    params, state = init_model(jax.random.key(0), spec)
    x = jax.random.normal(jax.random.key(1), (2, img, img, in_ch))
    feats, logits, new_state = forward(params, state, x, spec, train=False)
    assert feats.shape == (2, feat)
    assert logits.shape == (2, 10)
    assert np.isfinite(np.asarray(logits)).all()


def test_resnet20_downsample_only_stage3():
    """skip_single_downsample: only the stage-3 first block halves resolution
    (reference backbone.py:164-167, 291-302)."""
    spec = build_spec("ResNet20qat", in_channels=24, img_size=16)
    layout = list(spec.block_layout())
    assert len(layout) == 9
    halves = [h for (_, _, h) in layout]
    assert halves == [False] * 6 + [True, False, False]
    dims = [(i, o) for (i, o, _) in layout]
    assert dims[0] == (48, 48) and dims[3] == (48, 56) and dims[6] == (56, 64)


def test_resnet18_downsamples():
    spec = build_spec("ResNet18qat", in_channels=64, img_size=56)
    layout = list(spec.block_layout())
    assert len(layout) == 8
    halves = [h for (_, _, h) in layout]
    assert halves == [False, False, True, False, True, False, True, False]


def test_train_forward_updates_bn_state():
    spec = build_spec("ResNet20qat", in_channels=24, img_size=16)
    params, state = init_model(jax.random.key(0), spec)
    x = jax.random.normal(jax.random.key(1), (4, 16, 16, 24)) * 3 + 1
    _, _, new_state = forward(params, state, x, spec, train=True)
    before = state["blocks"][0]["bn1"]["mean"]
    after = new_state["blocks"][0]["bn1"]["mean"]
    assert not np.allclose(np.asarray(before), np.asarray(after))


def test_grads_flow_through_quant():
    spec = build_spec("ResNet20qat", in_channels=24, img_size=16)
    params, state = init_model(jax.random.key(0), spec)
    x = jax.random.normal(jax.random.key(1), (2, 16, 16, 24))
    y = jnp.array([1, 3])

    def loss_fn(p):
        _, logits, _ = forward(p, state, x, spec, train=True)
        one_hot = jax.nn.one_hot(y, 10)
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * one_hot, -1))

    grads = jax.grad(loss_fn)(params)
    g_conv = np.asarray(grads["blocks"][0]["c1"]["w"])
    g_scale = np.asarray(grads["blocks"][0]["relu1"]["scale"])
    assert np.abs(g_conv).sum() > 0
    assert np.isfinite(g_scale)
