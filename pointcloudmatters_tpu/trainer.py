"""Trainer: a jitted data-parallel training loop.

Replaces PyTorch Lightning's ``Trainer`` (the reference delegates its entire
runtime to it — SURVEY §2.3) with the JAX equivalent:

- a 1-D ``jax.sharding.Mesh`` over local devices, axis ``"data"``; params and
  optimizer state replicated, batches sharded on the leading dim. Under
  GSPMD the gradient all-reduce emerges from XLA's partitioner (the psum that
  DDP does by hand), and batch-norm statistics are *globally* exact for free
  — masked sums are computed over the logically-global array, which is the
  reference's ``sync_batchnorm: true`` (`configs/trainer/ddp.yaml:8`) without
  any extra code.
- one fused, donated train step under ``jax.jit``: forward + loss + backward
  + optimizer + batch-stats update in a single XLA program
- mixed precision (``precision="bf16-mixed"``): f32 master params, params and
  batch cast to bf16 inside the step; normalization statistics remain f32
- checkpoints as ``.npz`` directories (``utils/checkpoint``); Lightning-style
  callbacks and metric loggers

Config-schema parity: constructor accepts the reference's trainer YAML keys
(`configs/trainer/*.yaml`); Lightning-only knobs without a meaning here are
accepted and ignored.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
import time
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pointcloudmatters_tpu.utils.checkpoint import load_tree, save_tree
from pointcloudmatters_tpu.utils.loggers import as_multi_logger
from pointcloudmatters_tpu.utils.pylogger import RankedLogger

log = RankedLogger(__name__, rank_zero_only=True)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["step", "params", "batch_stats", "opt_state", "rng"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class TrainState:
    step: jax.Array
    params: Any
    batch_stats: Any
    opt_state: Any
    rng: jax.Array

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def _cast_floating(tree: Any, dtype) -> Any:
    def cast(x):
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating):
            return x.astype(dtype)
        return x

    return jax.tree.map(cast, tree)


# "gpu" requires a visible GPU; "cpu" switches JAX to the host platform;
# "auto" takes whatever platform JAX initialised.
_ACCELERATORS = ("gpu", "cpu", "auto")


def _limit(n_batches: int, limit) -> int:
    if limit is None:
        return n_batches
    if isinstance(limit, float):
        return max(1, int(n_batches * limit)) if limit > 0 else 0
    return min(n_batches, int(limit))


class Trainer:
    def __init__(
        self,
        default_root_dir: str = ".",
        min_epochs: int = 1,
        max_epochs: int = 10,
        accelerator: str = "auto",
        devices: Any = "auto",
        check_val_every_n_epoch: int = 1,
        precision: str = "32-true",
        gradient_clip_val: Optional[float] = None,
        accumulate_grad_batches: int = 1,
        deterministic: bool = False,
        detect_anomaly: bool = False,
        limit_train_batches: Any = 1.0,
        limit_val_batches: Any = 1.0,
        log_every_n_steps: int = 50,
        num_sanity_val_steps: int = 0,
        callbacks: Any = None,
        logger: Any = None,
        # Lightning-parity knobs, accepted for config compatibility:
        strategy: str = "data_parallel",
        num_nodes: int = 1,
        sync_batchnorm: bool = True,  # implicit under GSPMD (see module doc)
        profiler: Optional[str] = None,
        fast_dev_run: bool = False,
        overfit_batches: float = 0.0,
        # PRNG backend for all jax.random draws (dropout masks, VAE noise,
        # diffusion noise). "rbg" uses XLA's RngBitGenerator, which is
        # cheaper than threefry for the large dropout masks. rbg streams are
        # deterministic per seed but, unlike threefry, not guaranteed stable
        # across backends/XLA releases or device layouts; set
        # "threefry2x32" for that guarantee.
        prng_impl: str = "rbg",
        **_ignored,
    ):
        if prng_impl:
            jax.config.update("jax_default_prng_impl", prng_impl)
        self.prng_impl = prng_impl
        self.default_root_dir = os.path.abspath(default_root_dir)
        os.makedirs(self.default_root_dir, exist_ok=True)
        self.min_epochs = min_epochs or 1
        self.fast_dev_run = fast_dev_run
        self.max_epochs = 1 if fast_dev_run else max_epochs
        if accelerator not in _ACCELERATORS:
            raise ValueError(
                f"accelerator must be one of {_ACCELERATORS}, got {accelerator!r}"
            )
        self.accelerator = accelerator
        self.devices_spec = devices
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.precision = str(precision)
        self.gradient_clip_val = gradient_clip_val
        self.accumulate_grad_batches = max(1, accumulate_grad_batches)
        self.deterministic = deterministic
        self.detect_anomaly = detect_anomaly
        if detect_anomaly:
            # the true analog of torch's autograd anomaly mode: XLA checks
            # every primitive's output and raises at the FIRST nan/inf with
            # the offending operation's traceback (instead of only the
            # per-step finite-loss guard below). Debug-only: this forces
            # de-optimized, synchronized execution.
            jax.config.update("jax_debug_nans", True)
        self.limit_train_batches = 1 if fast_dev_run else limit_train_batches
        self.limit_val_batches = 1 if fast_dev_run else limit_val_batches
        self.log_every_n_steps = log_every_n_steps
        self.num_sanity_val_steps = num_sanity_val_steps
        if callbacks is None:
            callbacks = []
        elif isinstance(callbacks, dict):
            callbacks = [cb for cb in callbacks.values() if cb is not None]
        self.callbacks = list(callbacks)
        self.logger = as_multi_logger(logger)
        self.profiler = profiler
        self.strategy = strategy
        self.num_nodes = num_nodes
        self.sync_batchnorm = sync_batchnorm
        self.overfit_batches = overfit_batches

        self.state: Optional[TrainState] = None
        self.global_step = 0
        self.current_epoch = 0
        self.should_stop = False
        self.estimated_stepping_batches: Optional[int] = None
        self.checkpoint_callback = next(
            (cb for cb in self.callbacks if hasattr(cb, "best_model_path")), None
        )
        self._schedule = None
        self.train_step = None  # the jitted step of the last fit()
        self._mesh: Optional[Mesh] = None
        self._module = None

    # ------------------------------------------------------------------
    # Devices / mesh / sharding
    # ------------------------------------------------------------------
    def _select_devices(self) -> list:
        if self.accelerator == "cpu" and jax.default_backend() != "cpu":
            try:
                jax.config.update("jax_platforms", "cpu")
            except RuntimeError:
                log.warning("cannot switch platform after JAX init; continuing")
        if self.accelerator == "gpu" and jax.default_backend() != "gpu":
            raise RuntimeError(
                f"trainer.accelerator=gpu but JAX found no GPU (platform "
                f"{jax.default_backend()!r}); use trainer=cpu to run on the host"
            )
        devs = jax.devices()
        spec = self.devices_spec
        if isinstance(spec, int) and spec > 0:
            devs = devs[:spec]
        return devs

    @property
    def mesh(self) -> Mesh:
        if self._mesh is None:
            self._mesh = Mesh(np.array(self._select_devices()), ("data",))
        return self._mesh

    def _replicate(self, tree: Any) -> Any:
        sharding = NamedSharding(self.mesh, P())
        if jax.process_count() > 1:
            # device_put cannot target non-addressable devices; every process
            # holds the identical host value (same seed), so assembling the
            # replicated global array from per-process copies is exact
            return jax.tree.map(
                lambda x: jax.make_array_from_process_local_data(
                    sharding, np.asarray(x)
                ),
                jax.device_get(tree),
            )
        return jax.device_put(tree, sharding)

    def shard_batch(self, batch: Any) -> Any:
        """Device placement for one batch.

        Single-process: leading-dim sharding where divisible by the mesh,
        else replicate. Multi-process: each process holds its LOCAL shard
        (``data/loader.py`` strided the index stream by rank); the global
        array is assembled with ``jax.make_array_from_process_local_data``
        so the jitted step sees one logical batch of
        ``process_count * local_batch`` rows sharded over the global mesh —
        the equivalent of DDP (`configs/trainer/ddp.yaml:4-13`).
        """
        ndev = self.mesh.devices.size
        nproc = jax.process_count()

        if nproc > 1:
            ndev_local = ndev // nproc

            def put_global(x):
                x = np.asarray(x)
                if (
                    x.ndim >= 1 and x.shape[0] > 0
                    and x.shape[0] % max(1, ndev_local) == 0
                ):
                    spec = P("data", *([None] * (x.ndim - 1)))
                else:  # replicated leaf: identical on every process
                    spec = P()
                return jax.make_array_from_process_local_data(
                    NamedSharding(self.mesh, spec), x
                )

            return jax.tree.map(put_global, batch)

        def put(x):
            x = np.asarray(x)
            if x.ndim >= 1 and x.shape[0] % ndev == 0 and x.shape[0] > 0:
                spec = P("data", *([None] * (x.ndim - 1)))
            else:
                spec = P()
            return jax.device_put(x, NamedSharding(self.mesh, spec))

        return jax.tree.map(put, batch)

    # ------------------------------------------------------------------
    # Jitted steps
    # ------------------------------------------------------------------
    def _mixed(self) -> bool:
        return self.precision in ("bf16-mixed", "16-mixed", "bf16", "16")

    def _build_train_step(self, module):
        tx = module.tx
        mixed = self._mixed()
        compute_dtype = jnp.bfloat16

        def train_step(state: TrainState, batch):
            step_rng = jax.random.fold_in(state.rng, state.step)
            rngs = module.make_rngs(step_rng)

            def loss_fn(params):
                p = _cast_floating(params, compute_dtype) if mixed else params
                b = _cast_floating(batch, compute_dtype) if mixed else batch
                out, mut = module.apply_train(
                    {"params": p, "batch_stats": state.batch_stats}, b,
                    rngs=rngs,
                )
                loss = out["loss"].astype(jnp.float32)
                metrics = {
                    k: out[k].astype(jnp.float32)
                    for k in module.train_metric_keys if k in out
                }
                return loss, (metrics, mut.get("batch_stats", state.batch_stats))

            (loss, (metrics, new_bs)), grads = jax.value_and_grad(
                loss_fn, has_aux=True
            )(state.params)
            grads = _cast_floating(grads, jnp.float32)
            updates, new_opt = tx.update(grads, state.opt_state, state.params)
            new_params = optax.apply_updates(state.params, updates)
            metrics["loss"] = loss
            metrics["grad_norm"] = optax.global_norm(grads)
            new_state = TrainState(
                step=state.step + 1, params=new_params, batch_stats=new_bs,
                opt_state=new_opt, rng=state.rng,
            )
            return new_state, metrics

        return jax.jit(train_step, donate_argnums=(0,))

    def _build_eval_step(self, module):
        def eval_step(state: TrainState, batch):
            out = module.apply_eval(
                {"params": state.params, "batch_stats": state.batch_stats}, batch
            )
            return {
                k: out[k].astype(jnp.float32)
                for k in module.val_metric_keys if k in out
            }

        return jax.jit(eval_step)

    # ------------------------------------------------------------------
    # Checkpointing
    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str, weights_only: bool = False) -> None:
        state = self.state
        item = {
            "params": jax.device_get(state.params),
            "batch_stats": jax.device_get(state.batch_stats),
            "step": int(state.step),
            "epoch": self.current_epoch,
        }
        if not weights_only:
            item["opt_state"] = jax.device_get(state.opt_state)
            item["rng"] = jax.device_get(state.rng)
        extra = self._module.state_dict_extras() if self._module else {}
        if extra:
            item["extras"] = extra
        save_tree(path, item)

    def restore_checkpoint(self, path: str) -> dict:
        path = os.path.abspath(path)
        raw = load_tree(path)  # plain containers; reveals saved keys
        state = self.state
        # second read against a structural template so optax namedtuples
        # and empty nodes round-trip exactly
        template = {"params": state.params, "batch_stats": state.batch_stats,
                    "step": 0, "epoch": 0}
        if "opt_state" in raw:
            template["opt_state"] = state.opt_state
        if "rng" in raw:
            template["rng"] = state.rng
        restored = load_tree(path, template)
        if "extras" in raw:
            restored["extras"] = raw["extras"]
        params = jax.tree.map(
            lambda t, r: jnp.asarray(r, t.dtype), state.params, restored["params"]
        )
        batch_stats = jax.tree.map(
            lambda t, r: jnp.asarray(r, t.dtype),
            state.batch_stats, restored["batch_stats"],
        )
        opt_state = restored.get("opt_state", state.opt_state)
        rng = jnp.asarray(restored.get("rng", state.rng))
        self.state = TrainState(
            step=jnp.asarray(restored.get("step", 0), jnp.int32),
            params=params, batch_stats=batch_stats, opt_state=opt_state, rng=rng,
        )
        self.current_epoch = int(restored.get("epoch", -1)) + 1
        self.global_step = int(restored.get("step", 0))
        if self._module and "extras" in restored:
            self._module.load_state_dict_extras(restored["extras"])
        log.info(f"Restored checkpoint from {path} (epoch {self.current_epoch})")
        return restored

    # ------------------------------------------------------------------
    # Logging
    # ------------------------------------------------------------------
    def log_metrics(self, metrics: dict) -> None:
        if metrics:
            self.logger.log_metrics(metrics, self.global_step)

    def current_lr(self) -> Optional[float]:
        if self._schedule is None or self.state is None:
            return None
        return float(self._schedule(int(self.state.step)))

    # ------------------------------------------------------------------
    # Fit
    # ------------------------------------------------------------------
    def fit(self, model, datamodule=None, ckpt_path: Optional[str] = None) -> None:
        self._module = model
        self.datamodule = datamodule
        if hasattr(datamodule, "setup"):
            datamodule.setup("fit")
        train_loader = datamodule.train_dataloader()
        n_train = _limit(len(train_loader), self.limit_train_batches)
        opt_steps_per_epoch = max(1, n_train // self.accumulate_grad_batches)
        self.estimated_stepping_batches = opt_steps_per_epoch * self.max_epochs

        # one example batch initializes params (shapes only; discarded after)
        try:
            example_batch = next(iter(train_loader))
        except StopIteration:
            raise RuntimeError(
                "train dataloader yielded no batches — the dataset has fewer "
                "samples than batch_size (drop_last drops the remainder); "
                "lower data.train.batch_size or add data"
            ) from None
        model.setup_module(self, example_batch)
        self._schedule = model.schedule
        self.state = self._replicate(model.initial_state(example_batch))
        if ckpt_path:
            self.restore_checkpoint(ckpt_path)

        for cb in self.callbacks:
            cb.setup(self, model)
        for cb in self.callbacks:
            cb.on_fit_start(self, model)

        train_step = self._build_train_step(model)
        self.train_step = train_step
        from pointcloudmatters_tpu.utils.profiling import make_profiler

        profiler = make_profiler(self.profiler, self.default_root_dir)
        if profiler is not None:
            profiler.start()
        t_fit = time.time()
        log.info(
            f"fit: {self.mesh.devices.size} device(s), {n_train} batches/epoch, "
            f"{self.estimated_stepping_batches} optimizer steps total, "
            f"precision={self.precision}"
        )

        # Lightning-parity sanity check: run N validation batches before the
        # first epoch so a broken val path fails fast instead of after epoch
        # 1 (-1 = full validation). Metrics are discarded, as in Lightning
        # (which also forces this off under fast_dev_run).
        if (
            self.num_sanity_val_steps
            and not self.fast_dev_run
            and self.limit_val_batches not in (0, 0.0)
        ):
            n = int(self.num_sanity_val_steps)
            saved = self.limit_val_batches
            if n != -1:
                self.limit_val_batches = (
                    min(n, int(saved)) if isinstance(saved, int) else n
                )
            log.info(
                "sanity-checking the validation loop "
                f"({'all' if n == -1 else self.limit_val_batches} batches)"
            )
            try:
                self._run_validation(model, datamodule)
            finally:
                self.limit_val_batches = saved
                # discard sanity metrics: the noisy small-sample values must
                # not seed the persistent val/best trackers (the reference
                # resets them in on_train_start for the same reason,
                # `maniskill2_act_bc_module.py:56-62`)
                for attr in ("val_metrics", "best_val_metrics"):
                    m = getattr(model, attr, None)
                    if m is not None and hasattr(m, "reset"):
                        m.reset()

        start_epoch = self.current_epoch
        for epoch in range(start_epoch, self.max_epochs):
            self.current_epoch = epoch
            model.train_metrics.reset()
            t0, seen = time.time(), 0
            for i, batch in enumerate(train_loader):
                if i >= n_train:
                    break
                dev_batch = self.shard_batch(batch)
                self.state, metrics = train_step(self.state, dev_batch)
                self.global_step += 1
                seen += self._batch_size_of(batch)
                model.train_metrics.update(
                    {k: v for k, v in metrics.items()}, weight=1.0
                )
                for cb in self.callbacks:
                    cb.on_train_batch_end(self, model, metrics, i)
                if self.detect_anomaly:
                    loss_val = float(metrics["loss"])
                    if not math.isfinite(loss_val):
                        raise FloatingPointError(
                            f"non-finite loss {loss_val} at step {self.global_step}"
                        )
                if self.global_step % self.log_every_n_steps == 0:
                    host = {k: float(v) for k, v in metrics.items()}
                    lr = self.current_lr()
                    if lr is not None:
                        host["lr"] = lr
                    self.log_metrics(host)
            jax.block_until_ready(self.state.params)
            epoch_metrics = model.train_metrics.compute()
            dt = time.time() - t0
            if seen:
                epoch_metrics["samples_per_sec"] = seen / dt
            self.log_metrics(epoch_metrics)

            val_metrics: dict = {}
            if (
                self.check_val_every_n_epoch
                and (epoch + 1) % self.check_val_every_n_epoch == 0
                and self.limit_val_batches not in (0, 0.0)
            ):
                val_metrics = self._run_validation(model, datamodule)
                self.log_metrics(val_metrics)
                for cb in self.callbacks:
                    cb.on_validation_end(self, model, val_metrics, epoch)

            for cb in self.callbacks:
                cb.on_train_epoch_end(
                    self, model, {**epoch_metrics, **val_metrics}, epoch
                )
            if self.should_stop and epoch + 1 >= self.min_epochs:
                log.info(f"early stop at epoch {epoch}")
                break

        if profiler is not None:
            profiler.stop()
        for cb in self.callbacks:
            cb.on_fit_end(self, model)
        self.logger.finalize()
        log.info(f"fit done in {time.time() - t_fit:.1f}s "
                 f"({self.global_step} steps)")

    def _batch_size_of(self, batch) -> int:
        for leaf in jax.tree.leaves(batch):
            if hasattr(leaf, "shape") and np.ndim(leaf) >= 1:
                return int(np.shape(leaf)[0])
        return 0

    # ------------------------------------------------------------------
    # Validation
    # ------------------------------------------------------------------
    def _run_validation(self, model, datamodule) -> dict:
        return model.run_validation(self, datamodule)

    def validate(self, model, datamodule=None, ckpt_path: Optional[str] = None) -> dict:
        self._module = model
        self.datamodule = datamodule
        if hasattr(datamodule, "setup"):
            datamodule.setup("validate")
        # params only need a shape-template batch; a val-only datamodule (the
        # validate.py use case: load ckpt, eval — no train split) must work
        loader = None
        for name in ("train_dataloader", "val_dataloader", "test_dataloader"):
            fn = getattr(datamodule, name, None)
            if fn is None:
                continue
            try:
                candidate = fn()
            except Exception:
                continue
            if candidate is not None:
                loader = candidate
                break
        if loader is None:
            raise RuntimeError(
                "validate() needs at least one dataloader (train, val, or "
                "test) to build a shape-template batch for initialization"
            )
        example_batch = next(iter(loader))
        model.setup_module(self, example_batch)
        self._schedule = model.schedule
        self.state = self._replicate(model.initial_state(example_batch))
        if ckpt_path:
            self.restore_checkpoint(ckpt_path)
        metrics = self._run_validation(model, datamodule)
        self.log_metrics(metrics)
        self.logger.finalize()
        return metrics
