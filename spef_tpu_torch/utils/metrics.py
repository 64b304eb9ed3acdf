"""Running-average metric accumulators.

A copy of ``spef_tpu.utils.metrics`` (numpy only): ``AverageMeter``,
``RunningAverage`` and the median absolute deviation ``mad``.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence

import numpy as np

__all__ = ["AverageMeter", "RunningAverage", "mad"]


class AverageMeter:
    """Tracks current value, running sum, count and average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class RunningAverage:
    """A keyed collection of AverageMeters."""

    def __init__(self, keys: Sequence[str]):
        self.meters: Dict[str, AverageMeter] = {k: AverageMeter() for k in keys}

    def update(self, values: Dict[str, float], n: int = 1):
        for k, v in values.items():
            if k in self.meters:
                self.meters[k].update(float(v), n)

    def get(self, key: str) -> float:
        return self.meters[key].avg

    def get_multiple(self, keys: Iterable[str]) -> Dict[str, float]:
        return {k: round(self.meters[k].avg, 4) for k in keys}

    def reset(self):
        for m in self.meters.values():
            m.reset()


def mad(data) -> float:
    """Median absolute deviation (`evaluation.py:16-32`)."""
    arr = np.asarray(data)
    median = np.median(arr)
    return float(np.median(np.abs(arr - median)))
