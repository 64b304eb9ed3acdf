"""Port parity: ``train/optimizer.py`` against ``spef_tpu.train.optimizer``.

The same parameters and the same five gradients (numpy from a seed)
through ``torch.optim.SGD`` / ``Adam`` as the port builds them and through
the optax chain JAX builds, weight decay on and off, the learning rate
changed after the second step (``set_learning_rate`` on both sides): the
parameters within 1e-6 relative after every step (float32 on both sides;
Adam's ``(m / bc1) / (sqrt(v) / sqrt(bc2) + eps)`` and optax's
``m_hat / (sqrt(v_hat) + eps)`` round differently).  The host schedulers
give equal learning-rate sequences.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spef_tpu.train import optimizer as joptimizer
from spef_tpu_torch.train import optimizer

torch.set_num_threads(1)

SHAPES = {"kernel": (3, 3, 4, 8), "bias": (8,), "scale": (8,)}


def _params(seed):
    rs = np.random.RandomState(seed)
    return {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(seed, n=5):
    rs = np.random.RandomState(seed + 100)
    return [{k: (rs.randn(*s) * 10.0 ** rs.uniform(-3, 1)).astype(np.float32)
             for k, s in SHAPES.items()} for _ in range(n)]


@pytest.mark.parametrize("name", ["SGD", "Adam"])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_updates_match_optax(name, weight_decay):
    params = _params(0)
    lr0, lr1 = 0.05, 0.005
    tx, _ = joptimizer.import_optimizer(lr0, name, 0.9, weight_decay)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt, _ = optimizer.import_optimizer(list(tparams.values()), lr0, name, 0.9, weight_decay)
    for i, g in enumerate(_grads(0)):
        if i == 2:
            jstate = joptimizer.set_learning_rate(jstate, lr1)
            optimizer.set_learning_rate(opt, lr1)
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in tparams.items():
            want = np.asarray(jparams[k])
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(), err_msg=f"{k} step {i}")
    assert all(group["lr"] == lr1 for group in opt.param_groups)


def test_sgd_first_step_is_the_gradient():
    """optax's trace starts from zeros, so its first step is lr * g, as
    torch's buffer starts at g."""
    p = torch.nn.Parameter(torch.ones(3))
    opt, _ = optimizer.import_optimizer([p], 0.1, "SGD", 0.9)
    p.grad = torch.tensor([1.0, 2.0, 3.0])
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), [0.9, 0.8, 0.7], rtol=1e-6)


def test_multistep_schedule_matches_jax():
    j = joptimizer.MultiStepScheduler(base_lr=0.01, milestones=(3, 5), gamma=0.1)
    t = optimizer.MultiStepScheduler(base_lr=0.01, milestones=(3, 5), gamma=0.1)
    assert [j.step(e) for e in range(1, 9)] == [t.step(e) for e in range(1, 9)]
    assert t.lr == 0.01 * 0.1 ** 2


def test_plateau_schedule_matches_jax():
    metrics = [1.0, 0.9, 0.95, 0.97, 0.99, 0.8, 0.85, 0.86, 0.87, 0.88, None]
    j = joptimizer.PlateauScheduler(base_lr=0.1, patience=2, gamma=0.5)
    t = optimizer.PlateauScheduler(base_lr=0.1, patience=2, gamma=0.5)
    want = [j.step(e, m) for e, m in enumerate(metrics)]
    assert want == [t.step(e, m) for e, m in enumerate(metrics)]
    assert len(set(want)) > 2


def test_factory_picks_the_scheduler_and_rejects_unknown_names():
    p = [torch.nn.Parameter(torch.zeros(2))]
    opt, sched = optimizer.import_optimizer(p, 0.1, "Adam", scheduler="OnPlateau",
                                            milestones=(4, 9))
    assert isinstance(opt, torch.optim.Adam) and isinstance(sched, optimizer.PlateauScheduler)
    assert sched.patience == 4 and opt.defaults["eps"] == 1e-8
    with pytest.raises(ValueError):
        optimizer.import_optimizer(p, 0.1, "RMSprop")
    with pytest.raises(ValueError):
        optimizer.import_optimizer(p, 0.1, "SGD", scheduler="Cosine")
