"""Synthetic ManiSkill2-format trajectory generator for tests and smoke runs.

Writes an HDF5 (or ``.npz``) + JSON pair matching the replayed-demo layout the datasets
read (reference `maniskill2_single_task_pcd_act.py:36-87`):
traj_{i}/actions, traj_{i}/obs/{agent/qpos, pointcloud/{xyzw,rgb},
image/base_camera/{rgb,depth}, extra/goal_pos...}.
"""

from __future__ import annotations

import json
import os

import numpy as np


def make_synthetic_maniskill2(
    path: str,
    n_episodes: int = 3,
    episode_len: int = 20,
    action_dim: int = 7,
    qpos_dim: int = 9,
    cam_side: int = 16,
    n_cams: int = 1,
    img_side: int = 32,
    env_id: str = "PickCube-v0",
    seed: int = 0,
) -> str:
    """Writes ``path`` as HDF5, or as an ``.npz`` archive keyed by the same
    dataset paths when ``path`` ends in ``.npz`` (no h5py needed)."""
    rng = np.random.RandomState(seed)
    pts_per_cam = cam_side * cam_side
    datasets = {}
    for i in range(n_episodes):
        g = f"traj_{i}"
        T = episode_len
        datasets[f"{g}/actions"] = rng.randn(T, action_dim).astype(np.float32)
        obs = f"{g}/obs"
        datasets[f"{obs}/agent/qpos"] = rng.randn(T + 1, qpos_dim).astype(np.float32)
        datasets[f"{obs}/agent/qvel"] = rng.randn(T + 1, qpos_dim).astype(np.float32)
        # tabletop-ish cloud: xy in [-0.2,0.2], z in [0, 0.3]; ~20% w=0 junk
        xyz = rng.rand(T + 1, n_cams * pts_per_cam, 3).astype(np.float32)
        xyz[..., :2] = (xyz[..., :2] - 0.5) * 0.4
        xyz[..., 2] *= 0.3
        w = (rng.rand(T + 1, n_cams * pts_per_cam, 1) > 0.2).astype(np.float32)
        datasets[f"{obs}/pointcloud/xyzw"] = np.concatenate([xyz, w], -1)
        datasets[f"{obs}/pointcloud/rgb"] = rng.randint(
            0, 255, (T + 1, n_cams * pts_per_cam, 3)).astype(np.uint8)
        datasets[f"{obs}/image/base_camera/rgb"] = rng.randint(
            0, 255, (T + 1, img_side, img_side, 3)).astype(np.uint8)
        datasets[f"{obs}/image/base_camera/depth"] = (
            rng.rand(T + 1, img_side, img_side, 1) * 1024).astype(np.float32)
        datasets[f"{obs}/extra/goal_pos"] = rng.randn(T + 1, 3).astype(np.float32)
        datasets[f"{obs}/extra/obj_start_pos"] = rng.randn(T + 1, 3).astype(np.float32)
        datasets[f"{obs}/extra/target_angle_diff"] = rng.randn(T + 1).astype(np.float32)
    if str(path).endswith(".npz"):
        with open(path, "wb") as f:
            np.savez(f, **datasets)
    else:
        import h5py

        with h5py.File(path, "w") as f:
            for key, value in datasets.items():
                f.create_dataset(key, data=value)
    meta = {
        "episodes": [{"episode_id": i, "reset_kwargs": {"seed": i}} for i in range(n_episodes)],
        "env_info": {"env_id": env_id, "env_kwargs": {"obs_mode": "pointcloud"}},
    }
    json_path = os.path.splitext(str(path))[0] + ".json"
    with open(json_path, "w") as f:
        json.dump(meta, f)
    return str(path)


def make_synthetic_rlbench(
    root: str,
    task_name: str = "close_jar",
    n_episodes: int = 3,
    episode_len: int = 8,
    side: int = 16,
    stages=("train", "val"),
    seed: int = 0,
) -> str:
    """Write processed-format RLBench episodes
    (`scripts/preprocess_rlbench.py` output layout): per-episode .npy pickles
    of {"demo": [frame dicts], "task_goal": (512,)}."""
    import os

    from pointcloudmatters_tpu.data.components.rlbench.constants import (
        SCENE_BOUNDS,
        loc_bounds,
    )

    rng = np.random.RandomState(seed)
    lo = np.array(SCENE_BOUNDS[:3])
    hi = np.array(SCENE_BOUNDS[3:])
    pos_lo, pos_hi = (np.array(b) for b in loc_bounds[task_name])
    for stage in stages:
        out_dir = os.path.join(root, stage, task_name)
        os.makedirs(out_dir, exist_ok=True)
        for ep in range(n_episodes):
            demo = []
            for t in range(episode_len):
                quat = rng.randn(4)
                quat = quat / np.linalg.norm(quat)
                pos = rng.uniform(pos_lo, pos_hi)
                cloud = rng.uniform(lo, hi, (side, side, 3)).astype(np.float32)
                # sprinkle some out-of-bounds points to exercise the crop
                cloud[0, :2] = hi + 1.0
                demo.append({
                    "ignore_collisions": float(rng.rand() > 0.5),
                    "front_rgb": rng.randint(0, 255, (side, side, 3)).astype(np.uint8),
                    "front_depth": rng.rand(side, side).astype(np.float32),
                    "front_point_cloud": cloud,
                    "front_mask": rng.randint(0, 250, (side, side)).astype(np.float32),
                    "gripper_pose": np.concatenate([pos, quat]).astype(np.float32),
                    "gripper_open": float(rng.rand() > 0.5),
                })
            task_goal = rng.randn(512).astype(np.float32)
            np.save(os.path.join(out_dir, f"ep{ep}.npy"),
                    dict(demo=demo, task_goal=task_goal), allow_pickle=True)
    return root
