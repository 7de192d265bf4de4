"""Benchmark: ManiSkill2 ACT+point-cloud BC training throughput (samples/sec).

The BASELINE.md headline metric — samples/sec/chip for the flagship
``scratch_pointnet_pcd`` config (ACT hidden 512, 4 enc / 7 dec, chunk 100,
2048 FPS points x 16 kNN; PointNet per-point MLP over the padded cloud). One
full optimizer step per sample batch: forward + loss + backward + AdamW +
batch-stats, bf16-mixed, jitted, on every local device.

Each step is timed to ``block_until_ready``; the result is the median step
after warm-up. Prints ONE json line: {"metric", "value", "unit",
"vs_baseline", "mfu", "device": {platform, kind, count, card, power_limit}}.
A device whose kind is not in ``PEAK_BF16_FLOPS`` is an error: MFU is only
reported against a published peak.

``vs_baseline`` divides by the TOP of the analytic A100 baseline range
derived in BASELINE.md (the reference publishes no numbers). The range spans
the as-published f32 config (27-45 samples/s) through an AMP-tuned run
(110-200); dividing by 200 is the conservative comparison.
``vs_baseline_range`` spans the full uncertainty.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np

import jax

from __graft_entry__ import build_batch, build_flagship

# Analytic A100 throughput range (samples/sec) for ManiSkill2 ACT+pcd BC —
# [as-published f32 low, AMP-tuned high]; derivation in BASELINE.md.
A100_BASELINE_RANGE = (27.0, 200.0)

# Training FLOPs per sample for the flagship step (fwd x3 for backward),
# counting matmul work only (the kNN extraction and elementwise ops are
# excluded): PointNet MLP 1.69G + token projection 6.48G + FPS/kNN distance
# matmuls 0.25G + 4 encoder layers 52.9G (QKVO 4.3G + attention core 8.6G +
# ffn 0.27G each) + CVAE encoder 0.94G + live decoder layer 2.9G + heads
# 0.2G = 65.4 GFLOP fwd -> ~196 GFLOP/sample trained.
TRAIN_FLOPS_PER_SAMPLE = 196e9

# Dense bf16 tensor-core peak per device, keyed by JAX's ``device_kind``.
# H100 SXM: 989 TFLOP/s (NVIDIA H100 data sheet; no sparsity).
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
}

BATCH_SIZE = int(os.environ.get("BENCH_BATCH", "32"))
N_POINTS = int(os.environ.get("BENCH_POINTS", "10240"))
WARMUP = int(os.environ.get("BENCH_WARMUP", "5"))
STEPS = int(os.environ.get("BENCH_STEPS", "20"))


def peak_bf16_flops(device_kind: str) -> float:
    if device_kind not in PEAK_BF16_FLOPS:
        raise KeyError(
            f"no published bf16 peak for device kind {device_kind!r}; add it "
            f"to bench.PEAK_BF16_FLOPS with its source"
        )
    return PEAK_BF16_FLOPS[device_kind]


def device_info() -> dict:
    """What the result was measured on: JAX's view plus the card's name and
    power limit from nvidia-smi (a card below its maximum runs slower)."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"bench needs a GPU; JAX found {devices[0].platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card, power_limit = (part.strip() for part in smi.split(",", 1))
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices), "card": card, "power_limit": power_limit}


def main() -> None:
    from pointcloudmatters_tpu.models.bc_module import BCModule
    from pointcloudmatters_tpu.trainer import Trainer
    from pointcloudmatters_tpu.utils.compile_cache import enable_compile_cache

    device = device_info()
    peak = peak_bf16_flops(device["kind"])
    enable_compile_cache()

    policy = build_flagship()  # reference scale
    module = BCModule(
        policy=policy,
        optimizer={"type": "AdamW", "lr": 5e-5, "weight_decay": 0.05},
        lr_scheduler={"scheduler": {"type": "OneCycleLR", "max_lr": 5e-5,
                                    "pct_start": 0.1}},
    )
    trainer = Trainer(
        default_root_dir=tempfile.mkdtemp(prefix="pcm_bench_"), max_epochs=1,
        precision="bf16-mixed", devices="auto", accelerator="gpu",
    )
    batch = build_batch(batch_size=BATCH_SIZE, n_points=N_POINTS)
    module.setup_module(
        type("K", (), {"estimated_stepping_batches": 10_000,
                       "gradient_clip_val": None,
                       "accumulate_grad_batches": 1,
                       "seed": 0})(),
        batch,
    )
    state = trainer._replicate(module.initial_state(batch))
    sharded = trainer.shard_batch(batch)
    step = trainer._build_train_step(module)

    for _ in range(WARMUP):
        state, metrics = step(state, sharded)
    jax.block_until_ready(metrics)
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, sharded)
        jax.block_until_ready(metrics)
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)

    loss = float(metrics["loss"])
    assert np.isfinite(loss), f"non-finite loss {loss}"
    n_chips = trainer.mesh.devices.size
    sps_per_chip = BATCH_SIZE / dt / n_chips
    lo, hi = A100_BASELINE_RANGE
    print(json.dumps({
        "metric": "maniskill2_act_pcd_bc_train_throughput",
        "value": sps_per_chip,
        "unit": "samples/sec/chip",
        # conservative: against the TOP of the analytic A100 range
        "vs_baseline": sps_per_chip / hi,
        "vs_baseline_range": [sps_per_chip / hi, sps_per_chip / lo],
        "baseline_sps_range": [lo, hi],
        # the A100 range is ANALYTIC (the reference publishes none);
        # derivation in BASELINE.md
        "estimated_baseline": True,
        "mfu": sps_per_chip * TRAIN_FLOPS_PER_SAMPLE / peak,
        "median_step_s": dt,
        "device": device,
    }))


if __name__ == "__main__":
    main()
