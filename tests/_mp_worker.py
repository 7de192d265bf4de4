"""Worker process for the multi-process data-parallel trainer test.

Usage: python _mp_worker.py <pid> <nproc> <port> <outfile> <devices_per_proc>

Trains the tiny flagship (ACTPCD+PointNet, dryrun scale) for one epoch over a
deterministic synthetic dataset on a (nproc x devices_per_proc)-device global
mesh and writes the per-step losses to <outfile> as JSON. With nproc=1 this
is the single-process reference run.
"""

from __future__ import annotations

import json
import sys


def main() -> None:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    outfile, dev_per_proc = sys.argv[4], int(sys.argv[5])

    import jax

    # platform must be forced via config: an inherited JAX_PLATFORMS is read
    # at interpreter startup, so env edits here don't stick
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", dev_per_proc)
    if nproc > 1:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
        jax.distributed.initialize(
            f"127.0.0.1:{port}", nproc, pid, initialization_timeout=120
        )

    import numpy as np

    sys.path.insert(0, __file__.rsplit("/", 2)[0])  # repo root

    from __graft_entry__ import build_batch, build_flagship
    from pointcloudmatters_tpu.data.loader import DataLoader
    from pointcloudmatters_tpu.models.bc_module import BCModule
    from pointcloudmatters_tpu.trainer import Trainer

    N_SAMPLES, N_POINTS, CHUNK = 16, 64, 10
    GLOBAL_BATCH = 8

    template = build_batch(batch_size=N_SAMPLES, n_points=N_POINTS, chunk=CHUNK)

    class SyntheticDataset:
        def __len__(self):
            return N_SAMPLES

        def __getitem__(self, i):
            return {
                "qpos": template["qpos"][i],
                "actions": template["actions"][i],
                "is_pad": template["is_pad"][i],
                "goal_cond": template["goal_cond"][i],
                "pcds": {k: v[i] for k, v in template["pcds"].items()},
            }

    local_batch = GLOBAL_BATCH // nproc
    loader = DataLoader(SyntheticDataset(), batch_size=local_batch,
                        shuffle=False, drop_last=True)

    class DM:
        def setup(self, stage):
            pass

        def train_dataloader(self):
            return loader

    policy = build_flagship(hidden_dim=64, npoints=32, nsample=4, chunk=CHUNK,
                            enc_layers=1, dec_layers=1, ffn=32)
    module = BCModule(
        policy=policy,
        optimizer={"type": "AdamW", "lr": 1e-3, "weight_decay": 0.0},
        lr_scheduler={"scheduler": {"type": "OneCycleLR", "max_lr": 1e-3,
                                    "pct_start": 0.1}},
    )
    trainer = Trainer(
        default_root_dir=f"/tmp/pcm_mp_{nproc}_{pid}", max_epochs=1,
        precision="32-true", devices="auto", log_every_n_steps=1,
        check_val_every_n_epoch=0,  # no val split in this synthetic run
        prng_impl="threefry2x32",  # bitwise-stable across layouts
    )

    losses: list[float] = []
    orig_build = trainer._build_train_step

    def wrapped_build(module):
        step = orig_build(module)

        def step_and_record(state, batch):
            new_state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            return new_state, metrics

        return step_and_record

    trainer._build_train_step = wrapped_build
    trainer.fit(module, DM())

    with open(outfile, "w") as f:
        json.dump({"pid": pid, "nproc": nproc, "losses": losses,
                   "n_devices": len(jax.devices())}, f)


if __name__ == "__main__":
    main()
