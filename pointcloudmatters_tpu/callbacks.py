"""Trainer callbacks.

Covers the reference's Lightning callback config group
(`configs/callbacks/*.yaml`): ModelCheckpoint (top-k on a monitored metric +
save_last, `configs/callbacks/default.yaml:10-16`), EarlyStopping,
LearningRateMonitor, ModelSummary, RichProgressBar (console epoch lines),
DeviceStatsMonitor (jax device memory stats). Checkpoint IO is
``utils/checkpoint``, orchestrated by ``Trainer.save_checkpoint``.
"""

from __future__ import annotations

import math
import os
import re
import shutil
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from pointcloudmatters_tpu.utils.pylogger import RankedLogger

log = RankedLogger(__name__, rank_zero_only=True)


class Callback:
    def setup(self, trainer, module) -> None:
        pass

    def on_fit_start(self, trainer, module) -> None:
        pass

    def on_train_batch_end(self, trainer, module, metrics: dict,
                           batch_idx: int) -> None:
        pass

    def on_train_epoch_end(self, trainer, module, metrics: dict, epoch: int) -> None:
        pass

    def on_validation_end(self, trainer, module, metrics: dict, epoch: int) -> None:
        pass

    def on_fit_end(self, trainer, module) -> None:
        pass


_FMT_TOKEN = re.compile(r"\{([^{}:]+)(?::([^{}]+))?\}")


def _format_filename(pattern: str, metrics: dict, auto_insert: bool) -> str:
    """Format "epoch={epoch:03d}-acc={val/acc:.3f}" patterns whose keys may
    contain '/' (str.format can't)."""

    def sub(m):
        key, spec = m.group(1), m.group(2)
        value = metrics.get(key)
        if value is None:
            return "0"
        if spec:
            try:
                return format(value, spec)
            except (TypeError, ValueError):
                return format(float(value), spec)
        return str(value)

    name = _FMT_TOKEN.sub(sub, pattern)
    return name.replace("/", "_")


class ModelCheckpoint(Callback):
    """Top-k checkpointing on a monitored metric
    (reference `configs/callbacks/model_checkpoint.yaml`)."""

    def __init__(
        self,
        dirpath: Optional[str] = None,
        filename: Optional[str] = None,
        monitor: Optional[str] = None,
        verbose: bool = False,
        save_last: Optional[bool] = None,
        save_top_k: int = 1,
        mode: str = "min",
        auto_insert_metric_name: bool = True,
        save_weights_only: bool = False,
        every_n_train_steps: Optional[int] = None,
        every_n_epochs: Optional[int] = None,
    ):
        self.dirpath = dirpath
        self.filename = filename or "epoch_{epoch:03d}"
        self.monitor = monitor
        self.verbose = verbose
        self.save_last = bool(save_last)
        self.save_top_k = save_top_k
        assert mode in ("min", "max")
        self.mode = mode
        self.auto_insert_metric_name = auto_insert_metric_name
        self.save_weights_only = save_weights_only
        self.every_n_train_steps = every_n_train_steps
        self.every_n_epochs = every_n_epochs
        self.best_model_path: str = ""
        self.best_model_score: Optional[float] = None
        self.last_model_path: str = ""
        self._saved: list[tuple[float, str]] = []  # (score, path)

    def setup(self, trainer, module) -> None:
        if self.dirpath is None:
            self.dirpath = os.path.join(trainer.default_root_dir, "checkpoints")
        os.makedirs(self.dirpath, exist_ok=True)

    def _is_better(self, score: float, than: float) -> bool:
        return score < than if self.mode == "min" else score > than

    def _maybe_save_topk(self, trainer, metrics: dict, epoch: int) -> None:
        if self.monitor is None or self.monitor not in metrics:
            return
        score = float(metrics[self.monitor])
        if math.isnan(score):
            return
        worst_kept = None
        if self.save_top_k not in (-1,) and len(self._saved) >= self.save_top_k:
            worst_kept = self._saved[-1][0]
        if worst_kept is not None and not self._is_better(score, worst_kept):
            return
        name = _format_filename(
            self.filename, {**metrics, "epoch": epoch, "step": trainer.global_step},
            self.auto_insert_metric_name,
        )
        path = os.path.join(self.dirpath, name)
        trainer.save_checkpoint(path, weights_only=self.save_weights_only)
        self._saved.append((score, path))
        self._saved.sort(key=lambda t: t[0], reverse=(self.mode == "max"))
        if self.save_top_k != -1:
            for _, stale in self._saved[self.save_top_k:]:
                shutil.rmtree(stale, ignore_errors=True)
            self._saved = self._saved[: self.save_top_k]
        best_score, best_path = self._saved[0]
        self.best_model_score, self.best_model_path = best_score, best_path
        if self.verbose:
            log.info(f"Checkpoint saved: {path} ({self.monitor}={score:.5f})")

    def on_validation_end(self, trainer, module, metrics: dict, epoch: int) -> None:
        self._maybe_save_topk(trainer, metrics, epoch)

    def on_train_epoch_end(self, trainer, module, metrics: dict, epoch: int) -> None:
        if self.every_n_epochs and (epoch + 1) % self.every_n_epochs == 0:
            self._maybe_save_topk(trainer, metrics, epoch)
        if self.save_last:
            path = os.path.join(self.dirpath, "last")
            trainer.save_checkpoint(path, weights_only=False)
            self.last_model_path = path


class EarlyStopping(Callback):
    """`configs/callbacks/early_stopping.yaml` semantics."""

    def __init__(
        self,
        monitor: str,
        min_delta: float = 0.0,
        patience: int = 3,
        verbose: bool = False,
        mode: str = "min",
        strict: bool = True,
        check_finite: bool = True,
    ):
        self.monitor = monitor
        self.min_delta = abs(min_delta)
        self.patience = patience
        self.verbose = verbose
        assert mode in ("min", "max")
        self.mode = mode
        self.strict = strict
        self.check_finite = check_finite
        self.wait = 0
        self.best: Optional[float] = None

    def on_validation_end(self, trainer, module, metrics: dict, epoch: int) -> None:
        if self.monitor not in metrics:
            if self.strict:
                log.warning(f"EarlyStopping: metric '{self.monitor}' not found")
            return
        score = float(metrics[self.monitor])
        if self.check_finite and not math.isfinite(score):
            trainer.should_stop = True
            log.warning(f"EarlyStopping: non-finite {self.monitor}; stopping")
            return
        improved = self.best is None or (
            score < self.best - self.min_delta if self.mode == "min"
            else score > self.best + self.min_delta
        )
        if improved:
            self.best = score
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                trainer.should_stop = True
                if self.verbose:
                    log.info(f"EarlyStopping triggered on {self.monitor}")


class LearningRateMonitor(Callback):
    """Logs the scheduler lr each epoch (`configs/callbacks/lr_monitor.yaml`)."""

    def __init__(self, logging_interval: Optional[str] = None):
        self.logging_interval = logging_interval

    def on_train_epoch_end(self, trainer, module, metrics: dict, epoch: int) -> None:
        lr = trainer.current_lr()
        if lr is not None:
            trainer.log_metrics({"lr": lr})


class ModelSummary(Callback):
    """Parameter-count summary at fit start
    (`configs/callbacks/model_summary.yaml`)."""

    def __init__(self, max_depth: int = 1):
        self.max_depth = max_depth

    def on_fit_start(self, trainer, module) -> None:
        params = trainer.state.params if trainer.state is not None else None
        if params is None:
            return
        total = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(params))
        log.info(f"Model parameters: {total:,}")
        if self.max_depth != 0:
            top = {
                k: sum(int(np.prod(p.shape)) for p in jax.tree.leaves(v))
                for k, v in params.items()
            }
            for k, n in sorted(top.items(), key=lambda kv: -kv[1]):
                log.info(f"  {k}: {n:,}")


class RichProgressBar(Callback):
    """Console epoch/step reporting (stand-in for Lightning's rich bar)."""

    def __init__(self, refresh_rate: int = 1, leave: bool = False, **_):
        pass

    def on_train_epoch_end(self, trainer, module, metrics: dict, epoch: int) -> None:
        parts = " ".join(f"{k}={v:.5g}" for k, v in metrics.items())
        log.info(f"epoch {epoch}: {parts}")


ProgressBar = RichProgressBar


class StochasticWeightAveraging(Callback):
    """Stochastic Weight Averaging (reference
    `configs/callbacks/stochastic_weight_averaging.yaml:3` -> Lightning
    ``StochasticWeightAveraging``).

    Semantics mirrored from Lightning/torch ``swa_utils``:

    - from ``swa_epoch_start`` (fraction of ``max_epochs`` or an absolute
      epoch) the end-of-epoch parameters enter a uniform running average;
    - the LR anneals (cos) from its scheduled value at the SWA start to
      ``swa_lrs`` over ``annealing_epochs`` and then holds constant (torch
      ``SWALR``; modeled here by wrapping the compiled LR schedule and
      rebuilding the optax chain before the train step is jitted);
    - at fit end the averaged weights replace the model's and the
      BatchNorm running statistics are recomputed over the train loader as
      a UNIFORM average of per-batch statistics (torch
      ``update_bn``'s ``momentum=None`` cumulative mode). the module system hides the BN
      momentum inside each layer, so the refresh recovers exact per-batch
      stats by probing: one forward from zeroed stats gives
      ``(1-m)*batch``, one from ones gives ``m + (1-m)*batch`` — their
      difference is ``m`` per leaf, after which each batch's stats are
      exact. ``bn_update_steps`` bounds the refresh cost (-1 = full epoch).
    """

    def __init__(
        self,
        swa_lrs,
        swa_epoch_start: float = 0.8,
        annealing_epochs: int = 10,
        annealing_strategy: str = "cos",
        avg_fn=None,
        device=None,
        bn_update_steps: int = -1,
    ):
        del device  # Lightning API compat; placement is the mesh's concern
        if annealing_strategy not in ("cos", "linear"):
            raise ValueError(f"annealing_strategy={annealing_strategy!r}")
        self.swa_lrs = (
            float(swa_lrs[0]) if isinstance(swa_lrs, (list, tuple))
            else float(swa_lrs)
        )
        self.swa_epoch_start = swa_epoch_start
        self.annealing_epochs = int(annealing_epochs)
        self.annealing_strategy = annealing_strategy
        self.avg_fn = avg_fn
        self.bn_update_steps = bn_update_steps
        self.n_averaged = 0
        self._avg = None
        self._swa_start_epoch: Optional[int] = None

    # -- schedule wrapping -------------------------------------------------
    def _swa_schedule(self, base, swa_start_step: float, anneal_steps: float):
        swa_lr = self.swa_lrs
        lr0 = base(swa_start_step) if base is not None else swa_lr
        cos_strategy = self.annealing_strategy == "cos"

        def schedule(step):
            s = jnp.asarray(step, jnp.float32)
            t = jnp.clip((s - swa_start_step) / max(anneal_steps, 1.0), 0.0, 1.0)
            if cos_strategy:
                frac = (1.0 - jnp.cos(jnp.pi * t)) / 2.0
            else:
                frac = t
            annealed = lr0 + (swa_lr - lr0) * frac
            if base is None:
                return jnp.where(s < swa_start_step, swa_lr, annealed)
            return jnp.where(s < swa_start_step, base(s), annealed)

        return schedule

    def setup(self, trainer, module) -> None:
        if isinstance(self.swa_epoch_start, float) and self.swa_epoch_start < 1:
            self._swa_start_epoch = int(trainer.max_epochs * self.swa_epoch_start)
        else:
            self._swa_start_epoch = int(self.swa_epoch_start)
        # rebuild the optimizer with the SWALR-wrapped schedule; the train
        # step has not been jitted yet (Trainer.fit runs callbacks first)
        if not hasattr(module, "configure_optimizers"):
            return
        total = trainer.estimated_stepping_batches or 1
        steps_per_epoch = max(1, total // max(trainer.max_epochs, 1))
        swa_start_step = float(self._swa_start_epoch * steps_per_epoch)
        anneal_steps = float(self.annealing_epochs * steps_per_epoch)
        knobs = dict(getattr(module, "_opt_knobs", {"total_steps": total}))
        module.configure_optimizers(
            params=trainer.state.params, **knobs,
            schedule_transform=lambda base: self._swa_schedule(
                base, swa_start_step, anneal_steps
            ),
        )
        trainer._schedule = module.schedule
        # the wrapped chain's state tree can differ from the one built in
        # initial_state (e.g. constant-lr ScaleState -> ScaleByScheduleState);
        # re-init before any training step has run
        new_opt = jax.jit(module.tx.init)(trainer.state.params)
        trainer.state = trainer.state.replace(opt_state=new_opt)

    # -- parameter averaging ------------------------------------------------
    def on_train_epoch_end(self, trainer, module, metrics: dict, epoch: int) -> None:
        if epoch < (self._swa_start_epoch or 0):
            return
        params = trainer.state.params
        if self.avg_fn is not None:
            self._avg = (
                params if self._avg is None
                else jax.tree.map(
                    lambda a, p: self.avg_fn(a, p, self.n_averaged),
                    self._avg, params,
                )
            )
        elif self._avg is None:
            self._avg = params
        else:
            n = float(self.n_averaged)
            self._avg = jax.tree.map(
                lambda a, p: a + (p - a) / (n + 1.0), self._avg, params
            )
        self.n_averaged += 1

    # -- BN refresh + final swap -------------------------------------------
    def _refresh_batch_stats(self, trainer, module, params):
        stats = trainer.state.batch_stats
        if not stats or not jax.tree.leaves(stats):
            return stats
        dm = getattr(trainer, "datamodule", None)
        if dm is None:
            return stats
        loader = dm.train_dataloader()

        def run_with(stats_tree, batch, rngs):
            _, mut = module.apply_train(
                {"params": params, "batch_stats": stats_tree}, batch, rngs=rngs
            )
            return mut["batch_stats"]

        run_with = jax.jit(run_with)
        zeros = jax.tree.map(jnp.zeros_like, stats)
        ones = jax.tree.map(jnp.ones_like, stats)
        momentum = None
        acc, count = None, 0
        limit = self.bn_update_steps if self.bn_update_steps != -1 else len(loader)
        for i, batch in enumerate(loader):
            if i >= limit:
                break
            batch = trainer.shard_batch(batch)
            rngs = module.make_rngs(jax.random.PRNGKey(i))
            if momentum is None:
                a = run_with(zeros, batch, rngs)
                b = run_with(ones, batch, rngs)
                momentum = jax.tree.map(lambda x, y: y - x, a, b)
                batch_stat = jax.tree.map(
                    lambda x, m: x / jnp.maximum(1.0 - m, 1e-6), a, momentum
                )
            else:
                a = run_with(zeros, batch, rngs)
                batch_stat = jax.tree.map(
                    lambda x, m: x / jnp.maximum(1.0 - m, 1e-6), a, momentum
                )
            acc = (
                batch_stat if acc is None
                else jax.tree.map(
                    lambda s, x: s + (x - s) / (count + 1.0), acc, batch_stat
                )
            )
            count += 1
        return acc if acc is not None else stats

    def on_fit_end(self, trainer, module) -> None:
        if self._avg is None or self.n_averaged == 0:
            return
        log.info(
            f"SWA: swapping in the average of {self.n_averaged} epoch-end "
            f"parameter snapshots and refreshing BN statistics"
        )
        new_stats = self._refresh_batch_stats(trainer, module, self._avg)
        trainer.state = trainer.state.replace(
            params=self._avg, batch_stats=new_stats
        )


class DeviceStatsMonitor(Callback):
    """Logs per-device memory stats (`configs/callbacks/device_stats_monitor.yaml`);
    analog of Lightning's DeviceStatsMonitor."""

    def on_train_epoch_end(self, trainer, module, metrics: dict, epoch: int) -> None:
        stats = {}
        for d in jax.local_devices():
            mem = getattr(d, "memory_stats", lambda: None)()
            if mem:
                stats[f"device{d.id}/bytes_in_use"] = mem.get("bytes_in_use", 0)
        if stats:
            trainer.log_metrics(stats)
