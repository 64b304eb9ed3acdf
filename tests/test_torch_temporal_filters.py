"""Port parity: ``spef_tpu_torch.temporal.filters`` (a numpy copy) against
``spef_tpu.temporal.filters``: each of the seven filters fed the same random
sequence (with a reset in the middle) gives the same outputs, exactly."""

import numpy as np
import pytest

from spef_tpu.temporal import filters as jfilters
from spef_tpu_torch.temporal import filters

T = 30


def _quats(rs):
    q = rs.randn(T, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[T // 3] *= -1.0  # a sign flip for the Kalman filter's hemisphere check
    return q


CASES = {
    "FIRFilter": (dict(numtaps=9, cutoff=0.2, dim=4), lambda rs: rs.randn(T, 4)),
    "RCFilter": (dict(alpha=0.3), lambda rs: rs.randn(T, 3)),
    "LowPassFilter": (dict(alpha_ori=0.4, alpha_pos=0.2),
                      lambda rs: [{"ori": q, "pos": p}
                                  for q, p in zip(_quats(rs), rs.randn(T, 3))]),
    "QuaternionKalmanFilter": (dict(process_var=1e-3, meas_var=1e-2), _quats),
    "KalmanFilterPosSimple": (dict(dt=0.04, process_var=1e-3, meas_var=1e-2),
                              lambda rs: np.cumsum(rs.randn(T, 3) * 0.1, axis=0) + [0, 0, 10]),
    "MovingAverage": (dict(window=5), lambda rs: rs.rand(T, 16)),
    "ExponentialMovingAverage": (dict(alpha=0.25), lambda rs: rs.rand(T, 16)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_filter_matches_jax_exactly(name):
    kw, make = CASES[name]
    seq = make(np.random.RandomState(sorted(CASES).index(name)))
    mine, theirs = getattr(filters, name)(**kw), getattr(jfilters, name)(**kw)
    for t, x in enumerate(seq):
        if t == T // 2:
            mine.reset()
            theirs.reset()
        got, want = mine.update(x), theirs.update(x)
        if isinstance(want, dict):
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
        else:
            np.testing.assert_array_equal(got, want)


def test_every_jax_filter_is_ported():
    assert sorted(filters.__all__) == sorted(jfilters.__all__) == sorted(CASES)
