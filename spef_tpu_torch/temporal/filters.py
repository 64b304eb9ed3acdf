"""Alternative temporal filters: FIR, RC, Kalman, moving averages.

A copy of ``spef_tpu.temporal.filters`` (plain numpy, float64): the
reference's auxiliary filter library, which its main path does not use.
FIRFilter, RCFilter and LowPassFilter; QuaternionKalmanFilter and
KalmanFilterPosSimple; MovingAverage and ExponentialMovingAverage.  Each
keeps a small per-frame state on the host.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "FIRFilter",
    "RCFilter",
    "LowPassFilter",
    "QuaternionKalmanFilter",
    "KalmanFilterPosSimple",
    "MovingAverage",
    "ExponentialMovingAverage",
]


def _firwin(numtaps: int, cutoff: float) -> np.ndarray:
    """Hamming-windowed-sinc lowpass design (scipy.signal.firwin's)."""
    m = np.arange(numtaps) - (numtaps - 1) / 2.0
    h = np.sinc(cutoff * m) * cutoff
    w = np.hamming(numtaps)
    h = h * w
    return h / np.sum(h)


class FIRFilter:
    """Ring-buffer FIR filter over vector signals (`filter.py:6-72`)."""

    def __init__(self, numtaps: int = 15, cutoff: float = 0.1, dim: int = 4):
        self.taps = _firwin(numtaps, cutoff)
        self.numtaps = numtaps
        self.dim = dim
        self.reset()

    def reset(self):
        self.buffer = deque(maxlen=self.numtaps)

    def update(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        if not self.buffer:
            for _ in range(self.numtaps):
                self.buffer.append(x)
        else:
            self.buffer.append(x)
        stacked = np.stack(self.buffer)  # (numtaps, dim) newest last
        return np.einsum("t,td->d", self.taps[::-1], stacked)


class RCFilter:
    """Single-pole IIR (RC) lowpass (`filter.py:75-111`)."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self.state: Optional[np.ndarray] = None

    def reset(self):
        self.state = None

    def update(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        if self.state is None:
            self.state = x
        else:
            self.state = self.alpha * x + (1 - self.alpha) * self.state
        return self.state


class LowPassFilter:
    """Bank of RC filters for a pose dict (`filter.py:114-131`)."""

    def __init__(self, alpha_ori: float = 0.3, alpha_pos: float = 0.3):
        self.ori = RCFilter(alpha_ori)
        self.pos = RCFilter(alpha_pos)

    def reset(self):
        self.ori.reset()
        self.pos.reset()

    def update(self, pose: dict) -> dict:
        return {"ori": self.ori.update(pose["ori"]), "pos": self.pos.update(pose["pos"])}


class QuaternionKalmanFilter:
    """Linear Kalman filter on quaternion components with renormalization
    (`kalman.py:6-47`)."""

    def __init__(self, process_var: float = 1e-4, meas_var: float = 1e-2):
        self.q = np.eye(4) * process_var
        self.r = np.eye(4) * meas_var
        self.reset()

    def reset(self):
        self.x: Optional[np.ndarray] = None
        self.p = np.eye(4)

    def update(self, z: np.ndarray) -> np.ndarray:
        z = np.asarray(z, np.float64)
        if self.x is None:
            self.x = z.copy()
            return self.x
        # Quaternion double-cover: align measurement hemisphere with state.
        if np.dot(self.x, z) < 0:
            z = -z
        # Predict (identity dynamics).
        p_pred = self.p + self.q
        # Update.
        k = p_pred @ np.linalg.inv(p_pred + self.r)
        self.x = self.x + k @ (z - self.x)
        self.p = (np.eye(4) - k) @ p_pred
        self.x = self.x / np.linalg.norm(self.x)
        return self.x


class KalmanFilterPosSimple:
    """Constant-velocity position Kalman filter (`kalman.py:50-88`)."""

    def __init__(self, dt: float = 1.0 / 25, process_var: float = 1e-3, meas_var: float = 1e-2):
        self.dt = dt
        self.f = np.eye(6)
        self.f[:3, 3:] = np.eye(3) * dt
        self.h = np.zeros((3, 6))
        self.h[:, :3] = np.eye(3)
        self.q = np.eye(6) * process_var
        self.r = np.eye(3) * meas_var
        self.reset()

    def reset(self):
        self.x: Optional[np.ndarray] = None
        self.p = np.eye(6)

    def update(self, z: np.ndarray) -> np.ndarray:
        z = np.asarray(z, np.float64)
        if self.x is None:
            self.x = np.concatenate([z, np.zeros(3)])
            return z
        x_pred = self.f @ self.x
        p_pred = self.f @ self.p @ self.f.T + self.q
        innov = z - self.h @ x_pred
        s = self.h @ p_pred @ self.h.T + self.r
        k = p_pred @ self.h.T @ np.linalg.inv(s)
        self.x = x_pred + k @ innov
        self.p = (np.eye(6) - k @ self.h) @ p_pred
        return self.x[:3]


class MovingAverage:
    """Windowed moving average over PDFs/vectors (`moving_average.py:3-31`)."""

    def __init__(self, window: int = 5):
        self.window = window
        self.reset()

    def reset(self):
        self.buffer = deque(maxlen=self.window)

    def update(self, x: np.ndarray) -> np.ndarray:
        self.buffer.append(np.asarray(x, np.float64))
        return np.mean(np.stack(self.buffer), axis=0)


class ExponentialMovingAverage:
    """EMA over PDFs/vectors (`moving_average.py:34-59`)."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self.state: Optional[np.ndarray] = None

    def reset(self):
        self.state = None

    def update(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        if self.state is None:
            self.state = x
        else:
            self.state = self.alpha * x + (1 - self.alpha) * self.state
        return self.state
