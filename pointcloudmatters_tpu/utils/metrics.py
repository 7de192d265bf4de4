"""Metric aggregation.

Replaces the torchmetrics wrapper (`src/utils/metrics.py:7-53`) with plain
numpy accumulators. ``Metrics`` keeps the reference's key-routing config
schema: ``metrics`` (list of metric specs), ``input_keys`` (keys read from
the step output dict), ``output_keys`` (names emitted at epoch end). Metric
specs may be ``{"type": "MeanMetric"}`` dicts, ``_target_`` dicts whose tail
names a torchmetrics class, bare strings, or metric instances.

Cross-replica note: step outputs are already psum/pmean-reduced inside the
jitted step (the analog of ``sync_dist=True``), so host-side
accumulation here is global by construction.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np


class MeanMetric:
    def __init__(self):
        self.total = 0.0
        self.count = 0.0

    def update(self, value, weight: float = 1.0):
        v = float(np.asarray(value))
        if np.isnan(v):
            return
        self.total += v * weight
        self.count += weight

    def compute(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def reset(self):
        self.total = 0.0
        self.count = 0.0


class SumMetric(MeanMetric):
    def compute(self) -> float:
        return self.total


class MaxMetric:
    def __init__(self):
        self.value = -float("inf")

    def update(self, value, weight: float = 1.0):
        del weight
        self.value = max(self.value, float(np.asarray(value)))

    def compute(self) -> float:
        return self.value

    def reset(self):
        # reference MaxMetric persists across epochs for best-so-far tracking;
        # reset() restores the initial state when explicitly requested
        self.value = -float("inf")


class MinMetric:
    def __init__(self):
        self.value = float("inf")

    def update(self, value, weight: float = 1.0):
        del weight
        self.value = min(self.value, float(np.asarray(value)))

    def compute(self) -> float:
        return self.value

    def reset(self):
        self.value = float("inf")


_METRICS = {
    "MeanMetric": MeanMetric,
    "SumMetric": SumMetric,
    "MaxMetric": MaxMetric,
    "MinMetric": MinMetric,
}


def _build_metric(spec: Any):
    if isinstance(spec, str):
        name = spec
    elif isinstance(spec, dict):
        name = str(spec.get("type", spec.get("_target_", "MeanMetric")))
    elif hasattr(spec, "update") and hasattr(spec, "compute"):
        return spec
    else:
        raise TypeError(f"bad metric spec: {spec!r}")
    name = name.split(".")[-1]
    if name not in _METRICS:
        raise KeyError(f"unknown metric {name!r}; options: {sorted(_METRICS)}")
    return _METRICS[name]()


class Metrics:
    """Routes step-output keys into metric accumulators
    (`src/utils/metrics.py:7-53`)."""

    def __init__(
        self,
        metrics: Sequence[Any],
        input_keys: Sequence[str],
        output_keys: Sequence[str],
    ):
        assert len(metrics) == len(input_keys) == len(output_keys)
        self.metrics = [_build_metric(m) for m in metrics]
        self.input_keys = list(input_keys)
        self.output_keys = list(output_keys)

    def update(self, outputs: dict, weight: float = 1.0) -> None:
        for metric, key in zip(self.metrics, self.input_keys):
            if key in outputs and outputs[key] is not None:
                metric.update(outputs[key], weight)

    def compute(self) -> dict:
        return {
            out_key: metric.compute()
            for metric, out_key in zip(self.metrics, self.output_keys)
        }

    def reset(self) -> None:
        for metric in self.metrics:
            metric.reset()
