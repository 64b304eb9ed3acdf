"""Faults planted under a run's timed path, to see the comparison fail.

Each is a wrapper a run takes as its ``fault``: around the predict function
a stream calls, or around ``train_update`` for the training loop.

Serving: ``altered`` turns one frame's quaternion by 90 degrees and moves
its orientation PDF by half the bins where they are produced; ``half``
answers the window's second half with the first half's answers; ``stale``
returns the previous window's answer (state unchanged).
Training: ``unchanged`` runs the step and restores the parameters, the
BatchNorm running statistics and Adam's state; ``half`` steps on the first
half of the batch alone (the mean over the rest).
"""

from __future__ import annotations

import copy
from typing import Callable, Dict

import torch


def altered(fn: Callable) -> Callable:
    def call(x):
        out = dict(fn(x))
        q, p = out["ori"].clone(), out["ori_soft"].clone()
        q0, q1, q2, q3 = q[0].unbind()
        q[0] = torch.stack([q0 - q1, q0 + q1, q2 - q3, q2 + q3]) / 2 ** 0.5
        p[0] = torch.roll(p[0], p.shape[1] // 2)
        out["ori"], out["ori_soft"] = q, p
        return out
    return call


def half(fn: Callable) -> Callable:
    def call(x):
        n = x.shape[0]
        out = fn(x[: n // 2])
        return {k: torch.cat([v, v])[:n] for k, v in out.items()}
    return call


def stale(fn: Callable) -> Callable:
    last: Dict = {}

    def call(x):
        out = fn(x)
        prev = last.get("out", out)
        last["out"] = out
        return prev
    return call


def unchanged(update: Callable) -> Callable:
    def call(state, images, targets, *args, **kw):
        kept = [t.detach().clone() for t in (*state.model.parameters(), *state.model.buffers())]
        opt = copy.deepcopy(state.optimizer.state_dict())
        loss, pose = update(state, images, targets, *args, **kw)
        with torch.no_grad():
            for t, t0 in zip((*state.model.parameters(), *state.model.buffers()), kept):
                t.copy_(t0)
        state.optimizer.load_state_dict(opt)
        return loss, pose
    return call


def half_batch(update: Callable) -> Callable:
    def call(state, images, targets, *args, **kw):
        n = images.shape[0]
        loss, pose = update(state, images[: n // 2], {k: v[: n // 2] for k, v in targets.items()},
                            *args, **kw)
        return loss, {k: torch.cat([v, v])[:n] for k, v in pose.items()}
    return call


STREAM = {"altered": altered, "half": half, "stale": stale}
TRAIN = {"unchanged": unchanged, "half": half_batch}
