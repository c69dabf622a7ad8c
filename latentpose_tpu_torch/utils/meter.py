"""Running metric meter (port of ``latentpose_tpu/utils/meter.py``):
per-name running sum, count and last value, NaN-tolerant, mergeable with
``+=``."""

from __future__ import annotations

import math


class Meter:
    def __init__(self):
        self._sum = {}
        self._count = {}
        self._last = {}

    def add(self, name, value, count=1):
        value = float(value)
        if math.isnan(value):
            return
        self._sum[name] = self._sum.get(name, 0.0) + value * count
        self._count[name] = self._count.get(name, 0) + count
        self._last[name] = value

    def keys(self):
        return self._sum.keys()

    def get_average(self, name):
        if self._count.get(name, 0) == 0:
            return float("nan")
        return self._sum[name] / self._count[name]

    def get_last(self, name):
        return self._last.get(name, float("nan"))

    def __iadd__(self, other):
        for name in other.keys():
            self._sum[name] = self._sum.get(name, 0.0) + other._sum[name]
            self._count[name] = self._count.get(name, 0) + other._count[name]
            self._last[name] = other._last[name]
        return self
