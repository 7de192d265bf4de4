"""Multi-process (multi-host) data parallelism: loss parity with single-process.

VERDICT r1 item 3: the reference trains multi-node via Lightning DDP
(`configs/trainer/ddp.yaml:4-13`, SLURM init `common_utils.py:193-240`). Our
equivalent shards the loader's index stream by
``jax.process_index()`` and assembles global arrays with
``jax.make_array_from_process_local_data`` (`trainer.py shard_batch`).

This test runs the tiny flagship for one epoch twice:
- 1 process x 4 CPU devices (reference run)
- 2 processes x 2 CPU devices each (gloo collectives over localhost)

and asserts the per-step global losses match. Both runs see the same global
batches (strided index sharding unions to the same sample set; the loss is a
mean over the global batch, so intra-batch order is immaterial).
"""

from __future__ import annotations

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = str(pathlib.Path(__file__).resolve().parent / "_mp_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(nproc: int, dev_per_proc: int, tmp_path, timeout=420) -> list:
    port = _free_port()
    procs, outs = [], []
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)  # worker forces cpu via jax.config
    for pid in range(nproc):
        out = tmp_path / f"out_{nproc}_{pid}.json"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(pid), str(nproc), str(port),
             str(out), str(dev_per_proc)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        ))
    logs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"
    return [json.loads(o.read_text()) for o in outs]


@pytest.mark.slow
def test_two_process_loss_parity(tmp_path):
    single = _run_workers(1, 4, tmp_path)[0]
    assert single["n_devices"] == 4
    assert len(single["losses"]) == 2  # 16 samples / global batch 8

    multi = _run_workers(2, 2, tmp_path)
    for r in multi:
        assert r["n_devices"] == 4
        assert len(r["losses"]) == len(single["losses"])

    # every process observes the same (global) loss, and it matches the
    # single-process run step for step
    np.testing.assert_allclose(multi[0]["losses"], multi[1]["losses"], rtol=1e-6)
    np.testing.assert_allclose(
        multi[0]["losses"], single["losses"], rtol=2e-4,
        err_msg="multi-process training diverges from single-process",
    )
