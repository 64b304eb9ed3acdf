"""Port parity: BatchNorm in train mode against ``flax.linen.BatchNorm``.

flax decays its running variance toward the *biased* batch variance;
``torch.nn.BatchNorm2d`` toward the unbiased one, larger by n/(n-1).  The
port's ``models.layers.BatchNorm`` (used by ``models/layers.py`` and
``quant/qlayers.py``) is held to flax's at 8 values a channel, where the
two rules differ by 8/7: running statistics within 1e-6 relative (float32;
the port's two-pass variance and flax's E[x^2] - E[x]^2 differ by
rounding), the normalized output within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from spef_tpu_torch.models.layers import BatchNorm, ConvBnAct
from spef_tpu_torch.quant.qlayers import QConvBnAct

torch.set_num_threads(1)

C = 5


def _x(seed, n=2, h=2, w=2):
    """NHWC float32 with a channel mean away from 0: n*h*w values a channel."""
    rs = np.random.RandomState(seed)
    return (rs.randn(n, h, w, C) * rs.uniform(0.5, 3.0, C) + rs.uniform(-2, 2, C)
            ).astype(np.float32)


def _flax_train(x, mean0, var0):
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": jnp.linspace(0.5, 1.5, C), "bias": jnp.linspace(-1, 1, C)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    y, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    return np.asarray(y), np.asarray(upd["batch_stats"]["mean"]), np.asarray(
        upd["batch_stats"]["var"])


def _port(module, x, mean0, var0):
    with torch.no_grad():
        module.weight.copy_(torch.linspace(0.5, 1.5, C))
        module.bias.copy_(torch.linspace(-1, 1, C))
        module.running_mean.copy_(torch.from_numpy(mean0))
        module.running_var.copy_(torch.from_numpy(var0))
    module.train()
    y = module(torch.from_numpy(x).permute(0, 3, 1, 2))
    return (y.detach().permute(0, 2, 3, 1).numpy(), module.running_mean.numpy(),
            module.running_var.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_train_mode_running_stats_match_flax(seed):
    x = _x(seed)  # 8 values a channel
    mean0 = np.linspace(-0.5, 0.5, C).astype(np.float32)
    var0 = np.linspace(0.5, 2.0, C).astype(np.float32)
    want_y, want_mean, want_var = _flax_train(x, mean0, var0)
    y, mean, var = _port(BatchNorm(C), x, mean0, var0)
    np.testing.assert_allclose(mean, want_mean, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(var, want_var, rtol=1e-6)
    np.testing.assert_allclose(y, want_y, rtol=0, atol=1e-5)


def test_torch_batchnorm2d_is_the_fault_by_n_over_n_minus_1():
    """What the port used before: the batch term of torch's running
    variance is the unbiased variance, 8/7 of flax's at 8 values."""
    x = _x(3)
    mean0 = np.zeros(C, np.float32)
    var0 = np.ones(C, np.float32)
    _, _, want_var = _flax_train(x, mean0, var0)
    _, _, torch_var = _port(torch.nn.BatchNorm2d(C, eps=1e-5, momentum=0.1), x, mean0, var0)
    _, _, var = _port(BatchNorm(C), x, mean0, var0)
    np.testing.assert_allclose((torch_var - 0.9) / (want_var - 0.9), 8 / 7, rtol=1e-5)
    np.testing.assert_allclose((var - 0.9) / (want_var - 0.9), 1.0, rtol=1e-5)


def test_gradients_match_flax():
    x = _x(4, n=3, h=4, w=4)

    def jloss(xx, scale, bias):
        bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
        y, _ = bn.apply({"params": {"scale": scale, "bias": bias},
                         "batch_stats": {"mean": jnp.zeros(C), "var": jnp.ones(C)}}, xx,
                        mutable=["batch_stats"])
        return jnp.sum(jnp.sin(y))

    scale, bias = jnp.linspace(0.5, 1.5, C), jnp.linspace(-1, 1, C)
    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), scale, bias)
    bn = BatchNorm(C)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, C))
        bn.bias.copy_(torch.linspace(-1, 1, C))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    torch.sin(bn.train()(xt)).sum().backward()
    got = (xt.grad.permute(0, 2, 3, 1), bn.weight.grad, bn.bias.grad)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * max(1.0, np.abs(w).max()))


def test_eval_mode_uses_the_running_statistics():
    x = _x(5)
    bn = BatchNorm(C)
    with torch.no_grad():
        bn.running_mean.copy_(torch.linspace(-1, 1, C))
        bn.running_var.copy_(torch.linspace(0.5, 2, C))
    before = bn.running_var.clone()
    y = bn.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    want = (torch.from_numpy(x) - bn.running_mean) / torch.sqrt(bn.running_var + 1e-5)
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), want.numpy(), atol=1e-6)
    assert torch.equal(bn.running_var, before)


def test_both_layer_libraries_use_it():
    assert type(ConvBnAct(3, 4).bn) is BatchNorm
    assert type(QConvBnAct(3, 4).bn) is BatchNorm
