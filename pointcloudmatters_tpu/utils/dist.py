"""Distributed runtime helpers.

Counterparts of the reference's torch.distributed utilities
(`src/utils/dist.py:4-27`, `src/utils/common_utils.py:34-40,193-283`): rank /
world-size come from ``jax.process_*``; the NCCL all-reduce helpers become
host-level psum via ``jax.experimental.multihost_utils``; SLURM/TCP process
group bootstrap becomes ``jax.distributed.initialize`` (one host needs
nothing; several hosts need the coordinator address).
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np

from pointcloudmatters_tpu.utils.pylogger import RankedLogger

log = RankedLogger(__name__, rank_zero_only=True)


def get_rank() -> int:
    return jax.process_index()


def get_world_size() -> int:
    return jax.process_count()


def is_main_process() -> bool:
    return get_rank() == 0


def barrier() -> None:
    if get_world_size() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("pcm_barrier")


def init_dist(coordinator_address: Optional[str] = None,
              num_processes: Optional[int] = None,
              process_id: Optional[int] = None) -> None:
    """Multi-host bootstrap (reference ``init_dist_pytorch`` /
    ``init_dist_slurm``, `common_utils.py:193-240`). On a single host this is
    a no-op; SLURM env vars are auto-detected like the reference."""
    if num_processes is None and "SLURM_NTASKS" in os.environ:
        num_processes = int(os.environ["SLURM_NTASKS"])
        process_id = int(os.environ["SLURM_PROCID"])
        node_list = os.environ.get("SLURM_NODELIST", "localhost")
        host = node_list.split(",")[0].replace("[", "").split("-")[0]
        port = os.environ.get("MASTER_PORT", "29500")
        coordinator_address = coordinator_address or f"{host}:{port}"
    if num_processes in (None, 0, 1):
        log.info("single-process run; jax.distributed not initialized")
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    log.info(f"jax.distributed initialized: rank {get_rank()} / {get_world_size()}")


def all_reduce_mean(value) -> np.ndarray:
    """Cross-host mean of a host scalar/array (reference
    ``dist.all_reduce`` mean, `common_utils.py:34-40`)."""
    if get_world_size() <= 1:
        return np.asarray(value)
    from jax.experimental import multihost_utils

    summed = multihost_utils.process_allgather(np.asarray(value))
    return np.mean(summed, axis=0)


def merge_results_dist(results: list, tmpdir: str) -> Optional[list]:
    """Rank-file gather (reference `common_utils.py:260-283`): each process
    pickles its shard; rank 0 concatenates in rank order."""
    import pickle

    os.makedirs(tmpdir, exist_ok=True)
    rank, world = get_rank(), get_world_size()
    with open(os.path.join(tmpdir, f"result_part_{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    barrier()
    if rank != 0:
        return None
    merged: list = []
    for r in range(world):
        with open(os.path.join(tmpdir, f"result_part_{r}.pkl"), "rb") as f:
            merged.extend(pickle.load(f))
    return merged
