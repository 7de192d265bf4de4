"""Experiment loggers.

Covers the reference's logger config group (`configs/logger/*.yaml`):
CSV and TensorBoard natively, plus a fan-out ``MultiLogger``
(= ``many_loggers``). Other backends (wandb/comet/mlflow/neptune/aim) are
network services unavailable in this environment; their config slots accept
``CSVLogger``-compatible stand-ins.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Any, Optional


class BaseLogger:
    def log_metrics(self, metrics: dict, step: int) -> None:  # pragma: no cover
        raise NotImplementedError

    def log_hyperparams(self, params: dict) -> None:
        pass

    def finalize(self) -> None:
        pass


class CSVLogger(BaseLogger):
    """One metrics.csv per run (reference `configs/logger/csv.yaml`)."""

    def __init__(self, save_dir: str, name: str = "csv", prefix: str = ""):
        self.save_dir = os.path.join(save_dir, name) if name else save_dir
        os.makedirs(self.save_dir, exist_ok=True)
        self.prefix = prefix
        self.path = os.path.join(self.save_dir, "metrics.csv")
        self._fieldnames: list[str] = ["step"]
        self._rows: list[dict] = []

    def log_metrics(self, metrics: dict, step: int) -> None:
        row = {"step": step}
        for k, v in metrics.items():
            key = f"{self.prefix}{k}" if self.prefix else k
            row[key] = float(v)
            if key not in self._fieldnames:
                self._fieldnames.append(key)
        self._rows.append(row)
        self._flush()

    def _flush(self) -> None:
        with open(self.path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fieldnames)
            writer.writeheader()
            writer.writerows(self._rows)

    def log_hyperparams(self, params: dict) -> None:
        with open(os.path.join(self.save_dir, "hparams.json"), "w") as f:
            json.dump(params, f, indent=2, default=str)


class OfflineBackendLogger(CSVLogger):
    """Stand-in for a networked experiment-tracking backend (wandb, comet,
    mlflow, neptune, aim) in a zero-egress environment.

    Accepts the real backend's full constructor schema (so reference configs
    port verbatim), records it to ``backend_config.json`` next to the
    metrics, and logs everything through the CSV path. Swapping in a real
    adapter later only requires changing ``_target_`` — no config surgery.
    """

    backend = "offline"

    def __init__(self, save_dir: Optional[str] = None, name: str = "",
                 prefix: str = "", **backend_kwargs: Any):
        if save_dir is None:
            # mlflow-style configs carry tracking_uri instead of save_dir;
            # a URI is not a path — use file: URIs' path component, fall back
            # to "logs" for remote schemes (http(s)://host would otherwise
            # become a bogus directory tree)
            raw = str(
                backend_kwargs.get("tracking_uri")
                or backend_kwargs.get("run_directory")
                or "logs"
            )
            from urllib.parse import urlparse

            parsed = urlparse(raw)
            if parsed.scheme in ("", "file"):
                save_dir = (parsed.path or "logs") if parsed.scheme else raw
            else:
                save_dir = "logs"
        super().__init__(save_dir, name=name or self.backend, prefix=prefix)
        self.backend_config = dict(backend_kwargs)
        with open(os.path.join(self.save_dir, "backend_config.json"), "w") as fh:
            json.dump(
                {"backend": self.backend, **self.backend_config},
                fh, indent=2, default=str,
            )


class WandbLogger(OfflineBackendLogger):
    backend = "wandb"


class CometLogger(OfflineBackendLogger):
    backend = "comet"


class MLFlowLogger(OfflineBackendLogger):
    backend = "mlflow"


class NeptuneLogger(OfflineBackendLogger):
    backend = "neptune"


class AimLogger(OfflineBackendLogger):
    backend = "aim"


class TensorBoardLogger(BaseLogger):
    """TB event files via torch's SummaryWriter when available
    (reference `configs/logger/tensorboard.yaml`); degrades to CSV."""

    def __init__(self, save_dir: str, name: str = "tensorboard",
                 default_hp_metric: bool = False, prefix: str = "",
                 log_graph: bool = False, version: Optional[str] = None):
        del default_hp_metric, log_graph, version
        self.save_dir = os.path.join(save_dir, name) if name else save_dir
        os.makedirs(self.save_dir, exist_ok=True)
        self.prefix = prefix
        self._writer: Any = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir=self.save_dir)
        except Exception:
            self._fallback = CSVLogger(self.save_dir, name="")

    def log_metrics(self, metrics: dict, step: int) -> None:
        if self._writer is None:
            self._fallback.log_metrics(metrics, step)
            return
        for k, v in metrics.items():
            key = f"{self.prefix}{k}" if self.prefix else k
            self._writer.add_scalar(key, float(v), step)

    def log_hyperparams(self, params: dict) -> None:
        if self._writer is None:
            self._fallback.log_hyperparams(params)
            return
        self._writer.add_text("hparams", json.dumps(params, default=str))

    def log_figure(self, tag: str, figure, step: int) -> None:
        if self._writer is not None:
            self._writer.add_figure(tag, figure, step)

    def log_video(self, tag: str, frames, step: int, fps: int = 20) -> None:
        if self._writer is not None:
            import torch

            self._writer.add_video(
                tag, torch.as_tensor(frames)[None], step, fps=fps
            )

    def finalize(self) -> None:
        if self._writer is not None:
            self._writer.flush()
            self._writer.close()


class MultiLogger(BaseLogger):
    """Fan-out (reference `configs/logger/many_loggers.yaml`)."""

    def __init__(self, loggers: list):
        self.loggers = [lg for lg in loggers if lg is not None]

    def log_metrics(self, metrics: dict, step: int) -> None:
        for lg in self.loggers:
            lg.log_metrics(metrics, step)

    def log_hyperparams(self, params: dict) -> None:
        for lg in self.loggers:
            lg.log_hyperparams(params)

    def finalize(self) -> None:
        for lg in self.loggers:
            lg.finalize()


def as_multi_logger(logger) -> MultiLogger:
    if logger is None:
        return MultiLogger([])
    if isinstance(logger, MultiLogger):
        return logger
    if isinstance(logger, dict):
        return MultiLogger(list(logger.values()))
    if isinstance(logger, (list, tuple)):
        return MultiLogger(list(logger))
    return MultiLogger([logger])
