"""Proof that the ACT + PointNet point-cloud training path runs on an NVIDIA GPU.

    python chip_smoke.py          # one card: phases 1-5
    python chip_smoke.py --four   # four cards: phases 1, 3 and the 4-card step

Phases, all in this one process (it starts no other process that opens the
card):

1. device: JAX must see a GPU; prints its kind, the device count, and the
   card's name and power limit from ``nvidia-smi``.
2. kernels: the FPS kernel and the kNN against their references at the
   flagship's shapes, with both ends' times, and the point-cloud front end
   of the train step (FPS, kNN, grouping, pooling; forward and backward)
   with either FPS. This phase needs nothing beyond JAX, so it runs first.
3. installations: versions of the packages the main path imports (fails
   when one is missing) and of flax, orbax and h5py, which it does not
   need.
4. train: ``src/train.py``'s ``main(argv)`` runs the shipped flagship config
   (ACT hidden 512, 4/7 layers, 8 heads, chunk 100, 2,048 FPS points x 16
   kNN, PointNet, bf16-mixed) for a few steps of ``Trainer.fit`` on
   synthetic data of the configured cloud size. Prints compile time, the
   median step time after warm-up, memory, the loss, compilations after
   warm-up, the step time with the FPS kernel against the XLA FPS loop, and
   the top device ops of a profiled run of the step.
5. correctness: the bf16-mixed forward against the float32 forward under
   ``jax.default_matmul_precision("highest")``, same parameters and batch.

``--four`` replaces phases 2, 4 and 5 with one flagship train step at global
batch 16 on a 4-card ``("data",)`` mesh, compared with the same step on one
card.

Every phase fails loudly. The last line of standard output is one JSON
object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pointcloudmatters_tpu.callbacks import Callback  # noqa: E402
from pointcloudmatters_tpu.ops import fps_triton, pointops  # noqa: E402
from pointcloudmatters_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from pointcloudmatters_tpu.utils.profiling import (  # noqa: E402
    device_events,
    summarize_device_events,
)

FLAGSHIP_ARGV = [
    "exp_maniskill2_act_policy=base",
    "exp_maniskill2_act_policy/maniskill2_pcd_task@maniskill2_pcd_task=PickCube-v0",
    "exp_maniskill2_act_policy/maniskill2_model@maniskill2_model=scratch_pointnet_pcd",
]
# what the main path imports beyond JAX: the optimizer, the config engine
INSTALLATIONS = ("numpy", "optax", "yaml")
# reported, not needed: the model stack (``pointcloudmatters_tpu.nn``) and
# checkpoints (``utils/checkpoint``) are the repo's own, and h5py only reads
# .h5 trajectory files (this script writes .npz)
OPTIONAL_INSTALLATIONS = ("flax", "orbax.checkpoint", "h5py")
# FPS and kNN checks: (batch, points) of the shipped clouds after
# GridSamplePCD (at most 16,384, padded to a multiple of 512).
FPS_SHAPES = ((16, 16384), (16, 10240), (32, 10240))
FPS_NPOINTS = 2048
KNN_SHAPE = (16, 2048, 16384, 16)  # batch, queries, points, k
# the flagship step's front end: micro-batch 8 of 13,312 padded points
# (16,384 camera points after GridSamplePCD), hidden 512
FRONTEND_SHAPE = (8, 13312, 2048, 16, 512)  # batch, points, samples, k, width
FPS_REL_TOL = 1e-6
# kNN distances use the expansion |q|^2 + |x|^2 - 2 q.x, whose float32
# rounding is relative to |q|^2 + |x|^2, not to the distance: a query that is
# itself a cloud point gets 0 from one GEMM and ~1e-8 from another. Errors are
# therefore relative to max(distance, mean |x|^2 of the cloud).
KNN_REL_TOL = 1e-6
# bf16-mixed vs float32-highest forward: bf16 keeps 8 significant bits (unit
# roundoff 2^-9 ~ 2e-3) and the path has ~20 rounded layers between the
# cloud and a_hat, so a few 1e-3 of relative error is expected; 5e-2 leaves
# room without hiding a wrong kernel, which shows as O(1) error.
FORWARD_REL_TOL = 5e-2
# 1 vs 4 cards: the same math with reductions split differently. bf16
# cotangents can round differently (2^-9 relative), which the loss and the
# gradient norm see as ~1e-4. Adam's first update is lr * g / (|g| + eps),
# blind to the gradient's scale (the gradient norm checks that): an element
# whose tiny gradient flips sign moves the other way, so at most two
# opposite updates apart, and such elements must stay rare. Batch-norm
# statistics accumulate in float32.
FOUR_LOSS_REL_TOL = 1e-2
FOUR_GRAD_NORM_REL_TOL = 1e-2
FOUR_PARAM_SHARE_OFF_TOL = 0.02  # elements whose updates differ > 1e-2 lr
FOUR_BATCH_STATS_REL_TOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, *args, reps: int = 5):
    """(median seconds of ``reps`` calls after one warm-up call, last output);
    every call ends in ``block_until_ready``."""
    out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


# ---------------------------------------------------------------------------
# 1-2. device and installations
# ---------------------------------------------------------------------------

def phase_device(count: int) -> dict:
    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX found {platform!r}")
    if len(devices) < count:
        raise SystemExit(f"need {count} GPUs, JAX sees {len(devices)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    info = {"platform": platform, "kind": devices[0].device_kind,
            "count": len(devices)}
    log(f"[device] {info['kind']} x{info['count']} ({platform}), "
        f"jax {jax.__version__}")
    log(f"[device] nvidia-smi: {smi}")
    return info


def phase_installations() -> dict:
    """Prints each package's version; raises when the main path cannot run."""
    versions, missing = {}, []
    for name in INSTALLATIONS + OPTIONAL_INSTALLATIONS:
        try:
            mod = importlib.import_module(name)
        except ImportError:
            versions[name] = None
            if name in INSTALLATIONS:
                missing.append(name)
            log(f"[install] {name} MISSING"
                + ("" if name in INSTALLATIONS else " (not needed)"))
            continue
        versions[name] = getattr(mod, "__version__", "unknown")
        log(f"[install] {name} {versions[name]}")
    if missing:
        raise SystemExit(
            f"the training path imports {', '.join(missing)}, which this "
            f"installation lacks; it cannot run here"
        )
    return versions


# ---------------------------------------------------------------------------
# 3. kernels
# ---------------------------------------------------------------------------

def make_clouds(batch: int, n: int, seed: int = 0):
    """Tabletop-sized clouds with ragged valid counts, packed at the front."""
    rng = np.random.RandomState(seed)
    xyz = rng.rand(batch, n, 3).astype(np.float32)
    xyz[..., :2] = (xyz[..., :2] - 0.5) * 0.4
    xyz[..., 2] *= 0.3
    counts = np.full((batch,), n)
    counts[1:] = rng.randint(n // 2, n + 1, batch - 1)
    mask = np.arange(n)[None] < counts[:, None]
    return jnp.asarray(xyz), jnp.asarray(mask)


@jax.jit
def fps_shortfall(xyz, mask, idx):
    """Per-row worst relative shortfall of each pick's min-distance to the
    points chosen before it, against the round's maximum over valid points.
    0 means every pick was a farthest point; ties may fork, so the check
    does not compare index sequences."""
    xyz = xyz.astype(jnp.float32)
    B, N, _ = xyz.shape
    dist0 = jnp.where(mask, jnp.inf, -1.0)

    def body(dist, cols):
        prev, cur = cols
        p = jnp.take_along_axis(xyz, prev[:, None, None], axis=1)
        diff = xyz - p
        d = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
             + diff[..., 2] * diff[..., 2])
        dist = jnp.minimum(dist, d)
        best = jnp.max(dist, axis=-1)
        picked = jnp.take_along_axis(dist, cur[:, None], axis=1)[:, 0]
        short = (best - picked) / jnp.maximum(best, 1e-30)
        return dist, jnp.where(best > 0, short, jnp.where(picked < 0, 1.0, 0.0))

    _, short = jax.lax.scan(body, dist0, (idx[:, :-1].T, idx[:, 1:].T))
    return jnp.max(short, axis=0)


def check_fps(xyz, mask, npoints: int, *, interpret: bool = False) -> dict:
    """The FPS kernel against the XLA loop under HIGHEST precision."""
    kernel = lambda x, m: fps_triton.farthest_point_sampling_padded_triton(
        x, m, npoints, interpret=interpret)
    with jax.default_matmul_precision("highest"):
        ref = lambda x, m: pointops._farthest_point_sampling_padded_xla(
            x, m, npoints)
        t_ker, idx = timed(kernel, xyz, mask)
        t_ref, idx_ref = timed(ref, xyz, mask)
        short = float(jnp.max(fps_shortfall(xyz, mask, idx)))
        short_ref = float(jnp.max(fps_shortfall(xyz, mask, idx_ref)))
    same = float(jnp.mean((idx == idx_ref).astype(jnp.float32)))
    res = {"kernel_s": t_ker, "xla_s": t_ref, "shortfall": short,
           "xla_shortfall": short_ref, "same_index_share": same}
    if not short <= FPS_REL_TOL:
        raise AssertionError(f"FPS kernel pick short of the farthest: {res}")
    return res


def check_knn(new_xyz, xyz, mask, k: int) -> dict:
    """The chosen kNN against brute force: full distances, argsort."""
    with jax.default_matmul_precision("highest"):
        t_knn, (idx, d2) = timed(
            lambda q, x, m: pointops.knn_query_padded(q, x, m, k),
            new_xyz, xyz, mask)

        @jax.jit
        def brute(q, x, m):
            d = jnp.where(m[:, None, :], pointops._sqdist(q, x), pointops._BIG)
            order = jnp.argsort(d, axis=-1)[..., :k]
            return order, jnp.take_along_axis(d, order, axis=-1)

        t_ref, (idx_b, d2_b) = timed(brute, new_xyz, xyz, mask, reps=2)
    idx, d2, idx_b, d2_b = map(np.asarray, (idx, d2, idx_b, d2_b))
    idx_b = np.where(d2_b >= pointops._BIG, -1, idx_b)
    sq = np.asarray(jnp.sum(xyz * xyz, -1))
    scale = (np.sum(sq * np.asarray(mask), -1)
             / np.maximum(np.sum(np.asarray(mask), -1), 1))[:, None, None]
    floor = np.maximum(np.abs(d2_b), scale)
    rel = np.abs(d2 - d2_b) / floor
    rel = float(np.max(np.where(d2_b >= pointops._BIG, 0.0, rel)))
    # a neighbour outside the brute-force set is allowed only at a tie with
    # the k-th distance
    kth = d2_b[..., -1:]
    in_set = (idx[..., :, None] == idx_b[..., None, :]).any(-1)
    tie = np.abs(d2 - kth) <= KNN_REL_TOL * np.maximum(np.abs(kth), scale)
    mismatches = int(np.sum(~in_set & ~tie))
    res = {"knn_s": t_knn, "brute_s": t_ref, "dist_rel_err": rel,
           "set_mismatches": mismatches}
    if rel > KNN_REL_TOL or mismatches:
        raise AssertionError(f"kNN disagrees with brute force: {res}")
    return res


def frontend_grad_fn(fps, k: int):
    """Forward and backward of the train step's point-cloud front end as
    plain JAX: FPS, kNN, the token builder's projection, gather, subtract
    and max-pool, with gradients to the projection and the point features.
    ``fps(xyz, mask, npoints)`` is the FPS under test."""

    def loss(w, feat, xyz, mask, npoints):
        idx = fps(xyz, mask, npoints)
        new_xyz = jnp.take_along_axis(xyz, idx[..., None], axis=1)
        nn_idx, _ = pointops.knn_query_padded(new_xyz, xyz, mask, k)
        src = jnp.concatenate([xyz, feat], -1).astype(jnp.bfloat16)
        query = jnp.concatenate(
            [new_xyz, jnp.zeros(new_xyz.shape[:-1] + feat.shape[-1:])], -1)
        g = src @ w
        h = query.astype(jnp.bfloat16) @ w
        x = pointops.gather_rows_padded(g, nn_idx) - h[:, :, None, :]
        tokens = jnp.max(jax.nn.relu(x), axis=2)
        return jnp.mean(tokens.astype(jnp.float32) ** 2)

    return jax.jit(jax.grad(loss, argnums=(0, 1)), static_argnums=(4,))


def phase_frontend(shape=FRONTEND_SHAPE, *, interpret: bool = False) -> dict:
    """Times the front end of the flagship step with the FPS kernel and with
    the XLA loop, same inputs. Picks are checked by ``check_fps``; here the
    gradients must be finite, and their difference is reported (bf16
    rounding of two differently fused programs, or a tie that forked the
    FPS sequences)."""
    B, N, M, k, D = shape
    xyz, mask = make_clouds(B, N, seed=3)
    rng = np.random.RandomState(4)
    feat = jnp.asarray(rng.rand(B, N, 3 + D // 8).astype(np.float32))
    w = jnp.asarray(rng.randn(3 + feat.shape[-1], D).astype(np.float32)
                    * 0.1).astype(jnp.bfloat16)
    kernel = frontend_grad_fn(
        lambda x, m, n: fps_triton.farthest_point_sampling_padded_triton(
            x, m, n, interpret=interpret), k)
    plain = frontend_grad_fn(pointops._farthest_point_sampling_padded_xla, k)
    t_ker, g_ker = timed(kernel, w, feat, xyz, mask, M)
    t_xla, g_xla = timed(plain, w, feat, xyz, mask, M)
    diff = max(float(jnp.max(jnp.abs(a.astype(jnp.float32)
                                     - b.astype(jnp.float32))))
               for a, b in zip(g_ker, g_xla))
    res = {"kernel_s": t_ker, "xla_s": t_xla, "grad_max_abs_diff": diff}
    if not all(bool(jnp.isfinite(g.astype(jnp.float32)).all()) for g in g_ker):
        raise AssertionError(f"non-finite front-end gradients: {res}")
    return res


def phase_kernels() -> dict:
    out = {}
    for B, N in FPS_SHAPES:
        xyz, mask = make_clouds(B, N)
        res = check_fps(xyz, mask, FPS_NPOINTS)
        out[f"fps_B{B}_N{N}"] = res
        log(f"[kernels] fps B={B} N={N} npoints={FPS_NPOINTS}: kernel "
            f"{res['kernel_s'] * 1e3:.3f} ms, xla loop {res['xla_s'] * 1e3:.3f}"
            f" ms, worst pick shortfall {res['shortfall']:.2e} (tol "
            f"{FPS_REL_TOL:g}), xla's {res['xla_shortfall']:.2e}, same index "
            f"{res['same_index_share']:.4f}")
    B, M, N, k = KNN_SHAPE
    xyz, mask = make_clouds(B, N, seed=1)
    q = jnp.take_along_axis(
        xyz, pointops.farthest_point_sampling_padded(xyz, mask, M)[..., None],
        axis=1)
    res = check_knn(q, xyz, mask, k)
    out["knn"] = res
    log(f"[kernels] knn B={B} M={M} N={N} k={k}: {res['knn_s'] * 1e3:.3f} ms,"
        f" brute force {res['brute_s'] * 1e3:.3f} ms, distance rel err "
        f"{res['dist_rel_err']:.2e} (tol {KNN_REL_TOL:g}), set mismatches "
        f"{res['set_mismatches']}")
    res = phase_frontend()
    out["frontend"] = res
    B, N, M, k, D = FRONTEND_SHAPE
    log(f"[kernels] front end fwd+bwd B={B} N={N} M={M} k={k} D={D}: with "
        f"the FPS kernel {res['kernel_s'] * 1e3:.3f} ms, with the xla loop "
        f"{res['xla_s'] * 1e3:.3f} ms, gradient max |diff| "
        f"{res['grad_max_abs_diff']:g}")
    return out


# ---------------------------------------------------------------------------
# 4. train
# ---------------------------------------------------------------------------

class FitProbe(Callback):
    """Times every step of ``Trainer.fit`` (blocking on its metrics), counts
    compilations, and keeps the trainer and module for the later phases."""

    last: "FitProbe | None" = None

    def __init__(self):
        self.stamps: list[float] = []
        self.compiles: list[int] = []  # compilations seen at each stamp
        self.compile_s = 0.0
        self.n_compiles = 0
        self.trainer = self.module = None

    def _on_event(self, event, duration_s, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.n_compiles += 1
            self.compile_s += duration_s

    def on_fit_start(self, trainer, module) -> None:
        FitProbe.last = self
        jax.monitoring.register_event_duration_secs_listener(self._on_event)
        self.t0 = time.perf_counter()

    def on_train_batch_end(self, trainer, module, metrics, batch_idx) -> None:
        jax.block_until_ready(metrics)
        self.stamps.append(time.perf_counter())
        self.compiles.append(self.n_compiles)
        self.loss = float(metrics["loss"])

    def on_fit_end(self, trainer, module) -> None:
        self.trainer, self.module = trainer, module


def make_flagship_data(root: str, episodes: int, cam_side: int = 128,
                       seed: int = 0) -> str:
    """Synthetic ManiSkill2 trajectories drawn from ``seed``, as ``.npz``; at
    the default ``cam_side`` the clouds have the shipped size
    (``tests/make_synthetic_data.py --cam-side 128``: 16,384 points)."""
    from tests.synth import make_synthetic_maniskill2

    return make_synthetic_maniskill2(
        os.path.join(root, "traj.npz"), n_episodes=episodes, episode_len=20,
        cam_side=cam_side, seed=seed,
    )


def train_argv(data_file: str, root: str, steps: int, loop: int,
               extra: tuple = ()) -> list[str]:
    return FLAGSHIP_ARGV + [
        f"data.train.dataset_file={data_file}",
        f"data.train.cache_dir={root}/cache",
        f"+data.train.loop={loop}",
        f"trainer.limit_train_batches={steps}",
        "trainer.max_epochs=1",
        "+callbacks.fit_probe._target_=chip_smoke.FitProbe",
        f"paths.log_dir={root}/logs",
        f"hydra.run.dir={root}/run",
        *extra,
    ]


def profile_step(trainer, batch, trace_dir: str, steps: int = 3) -> dict:
    """Device op table of ``steps`` runs of the fitted train step."""
    step = trainer.train_step
    state = trainer.state
    state, metrics = step(state, batch)  # warm (already compiled)
    jax.block_until_ready(metrics)
    with jax.profiler.trace(trace_dir):
        for _ in range(steps):
            with jax.profiler.StepTraceAnnotation("train", step_num=_):
                state, metrics = step(state, batch)
        jax.block_until_ready(metrics)
    trainer.state = state
    return summarize_device_events(device_events(trace_dir))


def fps_in_step(trainer, module, batch, reps: int = 10) -> dict:
    """Median train-step time with the FPS kernel (the fitted step) and with
    the XLA loop (the same step traced with the point ops routed to XLA),
    alternating the two on the same state and batch."""
    with mock.patch.object(pointops, "kernel_route", lambda: "xla"):
        xla_step = trainer._build_train_step(module)
        t0 = time.perf_counter()
        state, metrics = xla_step(trainer.state, batch)  # traced under the patch
        jax.block_until_ready(metrics)
        compile_s = time.perf_counter() - t0
    times = {"kernel": [], "xla": []}
    for _ in range(reps):
        for name, step in (("kernel", trainer.train_step), ("xla", xla_step)):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            jax.block_until_ready(metrics)
            times[name].append(time.perf_counter() - t0)
    trainer.state = state
    return {"kernel_step_s": statistics.median(times["kernel"]),
            "xla_step_s": statistics.median(times["xla"]),
            "xla_first_step_s": compile_s}


def phase_train(root: str, steps: int = 10, warmup: int = 2,
                extra: tuple = (), episodes: int = 4, batch_size: int = 8,
                cam_side: int = 128, profile: bool = True,
                compare_fps: bool = True) -> dict:
    """``batch_size`` is the shipped ``scratch_pointnet_pcd`` micro-batch
    (8, with ``accumulate_grad_batches: 2``); it sizes the data only.
    ``compare_fps`` times the step with the FPS kernel against the step with
    the XLA loop (needs the GPU route)."""
    sys.modules.setdefault("chip_smoke", sys.modules[__name__])
    from src.train import main as train_main

    data_file = make_flagship_data(root, episodes, cam_side)
    loop = -(-steps * batch_size // episodes)
    t0 = time.perf_counter()
    train_main(train_argv(data_file, root, steps, loop, extra))
    fit_s = time.perf_counter() - t0
    probe = FitProbe.last
    trainer, module = probe.trainer, probe.module
    if len(probe.stamps) != steps:
        raise AssertionError(f"fit ran {len(probe.stamps)} of {steps} steps")
    if not np.isfinite(probe.loss):
        raise AssertionError(f"non-finite loss {probe.loss}")
    gaps = np.diff(probe.stamps)
    timed_gaps = gaps[warmup - 1:] if warmup > 0 else gaps
    batch = next(iter(trainer.datamodule.train_dataloader()))
    dev_batch = trainer.shard_batch(batch)
    t_c = time.perf_counter()
    compiled = trainer.train_step.lower(trainer.state, dev_batch).compile()
    relower_s = time.perf_counter() - t_c
    mem = compiled.memory_analysis()
    stats = jax.devices()[0].memory_stats() or {}
    res = {
        "fit_s": fit_s,
        "first_step_s": probe.stamps[0] - probe.t0,
        "backend_compile_s": probe.compile_s,
        "compiles_total": probe.n_compiles,
        "compiles_after_warmup": probe.compiles[-1] - probe.compiles[warmup - 1],
        "median_step_s": float(np.median(timed_gaps)),
        "step_s": [float(g) for g in gaps],
        "loss": probe.loss,
        "relower_s": relower_s,
        "memory": {k: getattr(mem, k) for k in dir(mem)
                   if k.endswith("_in_bytes")} if mem is not None else None,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "points_padded": int(batch["pcds"]["coord"].shape[1]),
        "batch_size": int(batch["pcds"]["coord"].shape[0]),
    }
    log(f"[train] {steps} steps of Trainer.fit, batch {res['batch_size']} x "
        f"{res['points_padded']} padded points: loss {res['loss']:.4f}")
    log(f"[train] set-up: first step {res['first_step_s']:.2f} s (trace + "
        f"compile), backend compile {res['backend_compile_s']:.2f} s over "
        f"{res['compiles_total']} compilations")
    log(f"[train] median step after {warmup} warm-up steps: "
        f"{res['median_step_s'] * 1e3:.2f} ms; steps (s): "
        + ", ".join(f"{g:.4f}" for g in gaps))
    log(f"[train] compilations after warm-up: {res['compiles_after_warmup']}")
    log(f"[train] memory_analysis: {res['memory']}; peak_bytes_in_use "
        f"{res['peak_bytes_in_use']}")
    if compare_fps:
        ab = fps_in_step(trainer, module, dev_batch)
        res["fps_in_step"] = ab
        log(f"[train] step with the FPS kernel {ab['kernel_step_s'] * 1e3:.3f}"
            f" ms, with the XLA FPS loop {ab['xla_step_s'] * 1e3:.3f} ms "
            f"(median of 10 each, alternating; the XLA variant's first step "
            f"incl. compile {ab['xla_first_step_s']:.2f} s)")
    if profile:
        prof = profile_step(trainer, dev_batch, os.path.join(root, "trace"))
        res["profile"] = prof
        log(f"[train] profiled window {prof['window_ns'] / 1e6:.3f} ms, busy "
            f"{prof['busy_ns'] / 1e6:.3f} ms, idle share "
            f"{prof['idle_share']}; top device ops:")
        for row in prof["top"]:
            log(f"[train]   {row['ns'] / 1e6:10.3f} ms  x{row['count']:<5d} "
                f"{row['op'][:110]}")
    res["_trainer"], res["_module"], res["_batch"] = trainer, module, batch
    return res


# ---------------------------------------------------------------------------
# 5. correctness at real width
# ---------------------------------------------------------------------------

def _cast(tree, dtype):
    from pointcloudmatters_tpu.trainer import _cast_floating

    return _cast_floating(tree, dtype)


def forward_error(module, params, batch_stats, batch) -> dict:
    """bf16-mixed eval forward (dropout off) vs the float32 forward under
    HIGHEST precision, on identical inputs: the batch is rounded to bf16
    once, so the comparison sees compute precision only."""
    host = jax.tree.map(np.asarray, batch)
    mixed_in = _cast(host, jnp.bfloat16)
    exact_in = _cast(mixed_in, jnp.float32)

    @jax.jit
    def fwd(variables, b):
        out = module.apply_eval(variables, b)
        return out["a_hat"].astype(jnp.float32), out["loss"].astype(jnp.float32)

    a_mix, l_mix = fwd({"params": _cast(params, jnp.bfloat16),
                        "batch_stats": batch_stats}, mixed_in)
    with jax.default_matmul_precision("highest"):  # retraces: part of the key
        a_ref, l_ref = fwd({"params": params, "batch_stats": batch_stats},
                           exact_in)
    a_mix, a_ref = np.asarray(a_mix, np.float64), np.asarray(a_ref, np.float64)
    res = {
        "a_hat_rel_l2": float(np.linalg.norm(a_mix - a_ref)
                              / max(np.linalg.norm(a_ref), 1e-30)),
        "loss_rel": float(abs(float(l_mix) - float(l_ref))
                          / max(abs(float(l_ref)), 1e-30)),
        "loss_mixed": float(l_mix), "loss_f32": float(l_ref),
        "finite": bool(np.isfinite(a_mix).all() and np.isfinite(a_ref).all()),
    }
    if not res["finite"] or res["a_hat_rel_l2"] > FORWARD_REL_TOL \
            or res["loss_rel"] > FORWARD_REL_TOL:
        raise AssertionError(f"bf16-mixed forward off the f32 reference: {res}")
    return res


def phase_correctness(train_res: dict) -> dict:
    trainer, module = train_res["_trainer"], train_res["_module"]
    state = trainer.state
    res = forward_error(module, state.params, state.batch_stats,
                        train_res["_batch"])
    log(f"[correct] a_hat rel L2 {res['a_hat_rel_l2']:.3e}, loss "
        f"{res['loss_mixed']:.5f} (bf16-mixed) vs {res['loss_f32']:.5f} "
        f"(f32 highest), rel {res['loss_rel']:.3e}; tol {FORWARD_REL_TOL:g} "
        f"(bf16 unit roundoff 2^-9 over ~20 rounded layers)")
    return res


# ---------------------------------------------------------------------------
# 6. four cards
# ---------------------------------------------------------------------------

def dp_step_compare(devices, cfg_argv: list[str], batch_size: int,
                    root: str) -> dict:
    """One flagship train step at global batch ``batch_size`` on a
    ``("data",)`` mesh over ``devices`` and on ``devices[0]`` alone."""
    from jax.sharding import Mesh

    from pointcloudmatters_tpu.utils import config as C

    cfg = C.compose(os.path.join(REPO, "configs"), "train", cfg_argv)
    C.set_runtime(output_dir=os.path.join(root, "run"), cwd=os.getcwd())
    C.resolve_config(cfg)
    datamodule = C.instantiate(cfg.data)
    datamodule.setup("fit")
    batch = next(iter(datamodule.train_dataloader()))
    assert batch["qpos"].shape[0] == batch_size, batch["qpos"].shape
    out = {}
    for name, devs in (("one", devices[:1]), ("many", devices)):
        module = C.instantiate(cfg.model)
        module.seed = cfg.seed
        trainer = C.instantiate(cfg.trainer, callbacks=[], logger=None)
        trainer._mesh = Mesh(np.array(devs), ("data",))
        trainer.estimated_stepping_batches = 100
        module.setup_module(trainer, batch)
        state = trainer._replicate(module.initial_state(batch))
        step = trainer._build_train_step(module)
        before = jax.device_get(state.params)
        state, metrics = step(state, trainer.shard_batch(batch))
        out[name] = {
            "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "params": jax.device_get(state.params),
            "batch_stats": jax.device_get(state.batch_stats),
            "before": before,
        }
    one, many = out["one"], out["many"]
    lr = float(module.schedule(0))  # the first update's learning rate
    leaves = lambda t: [np.asarray(x, np.float64) for x in jax.tree.leaves(t)]
    dp = [np.max(np.abs(a - b)) for a, b in
          zip(leaves(one["params"]), leaves(many["params"]))]
    n_el = sum(a.size for a in leaves(one["params"]))
    off = sum(int(np.sum(np.abs(a - b) > 1e-2 * lr)) for a, b in
              zip(leaves(one["params"]), leaves(many["params"])))
    moved = [np.max(np.abs(a - b)) for a, b in
             zip(leaves(one["params"]), leaves(one["before"]))]
    bs_rel = [np.max(np.abs(a - b) / np.maximum(np.abs(a), 1e-6)) for a, b in
              zip(leaves(one["batch_stats"]), leaves(many["batch_stats"]))]
    res = {
        "loss_one": one["loss"], "loss_many": many["loss"],
        "loss_rel": abs(one["loss"] - many["loss"]) / abs(one["loss"]),
        "grad_norm_rel": abs(one["grad_norm"] - many["grad_norm"])
        / abs(one["grad_norm"]),
        "param_max_abs_diff_over_lr": float(max(dp)) / lr,
        "param_share_off": off / n_el,
        "param_max_step_over_lr": float(max(moved)) / lr,
        "batch_stats_max_rel": float(max(bs_rel)) if bs_rel else 0.0,
        "n_devices": len(devices),
    }
    ok = (res["loss_rel"] <= FOUR_LOSS_REL_TOL
          and res["grad_norm_rel"] <= FOUR_GRAD_NORM_REL_TOL
          and res["param_share_off"] <= FOUR_PARAM_SHARE_OFF_TOL
          and res["param_max_abs_diff_over_lr"]
          <= 2 * res["param_max_step_over_lr"]
          and res["batch_stats_max_rel"] <= FOUR_BATCH_STATS_REL_TOL
          and res["param_max_step_over_lr"] > 0)
    if not ok:
        raise AssertionError(f"1- vs {len(devices)}-device step differ: {res}")
    return res


def phase_four(root: str, n: int = 4, batch_size: int = 16) -> dict:
    data_file = make_flagship_data(root, episodes=batch_size)
    # threefry draws the same dropout bits whatever the device layout; one
    # optimizer update per step so the parameters move
    argv = FLAGSHIP_ARGV + [
        f"data.train.dataset_file={data_file}",
        f"data.train.cache_dir={root}/cache",
        f"data.batch_size_train={batch_size}",
        "trainer.accumulate_grad_batches=1",
        f"trainer.devices={n}",
        "+trainer.prng_impl=threefry2x32",
        f"paths.log_dir={root}/logs",
    ]
    jax.config.update("jax_threefry_partitionable", True)
    res = dp_step_compare(jax.devices()[:n], argv, batch_size, root)
    log(f"[four] flagship step, global batch {batch_size}: loss "
        f"{res['loss_one']:.6f} (1 card) vs {res['loss_many']:.6f} ({n} "
        f"cards), rel {res['loss_rel']:.2e} (tol {FOUR_LOSS_REL_TOL:g}); "
        f"grad norm rel {res['grad_norm_rel']:.2e} (tol "
        f"{FOUR_GRAD_NORM_REL_TOL:g}); updated params: "
        f"{res['param_share_off']:.4%} of elements differ by > 0.01 lr (tol "
        f"{FOUR_PARAM_SHARE_OFF_TOL:.0%}), max |diff| "
        f"{res['param_max_abs_diff_over_lr']:.3f} lr (tol 2 x largest step "
        f"{res['param_max_step_over_lr']:.3f} lr); batch-norm stats max rel "
        f"{res['batch_stats_max_rel']:.2e} (tol {FOUR_BATCH_STATS_REL_TOL:g})")
    return res


# ---------------------------------------------------------------------------

def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card data-parallel step check")
    args = ap.parse_args(argv)
    info = phase_device(4 if args.four else 1)
    enable_compile_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if args.four:
            phase_installations()
            phase_four(root)
        else:
            phase_kernels()
            phase_installations()
            train_res = phase_train(root)
            phase_correctness(train_res)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"ok": True, "device": info}), flush=True)


if __name__ == "__main__":
    main()
