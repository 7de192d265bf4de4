#!/usr/bin/env bash
# Download ManiSkill2 demonstration trajectories and replay them into the
# observation modes used for training (reference
# scripts/download_and_replay_maniskill2.sh). Requires the mani_skill2
# package on the host (simulator side; not needed for training itself).
#
# Usage: bash scripts/download_and_replay_maniskill2.sh <ENV_ID> [OBS_MODE]
set -euo pipefail

ENV_ID=${1:?usage: download_and_replay_maniskill2.sh <ENV_ID> [OBS_MODE]}
OBS_MODE=${2:-pointcloud}   # pointcloud | rgbd
CONTROL_MODE=${3:-pd_ee_delta_pose}
NPROC=${NPROC:-8}

python -m mani_skill2.utils.download_demo "${ENV_ID}" -o data/maniskill2/demos

python -m mani_skill2.trajectory.replay_trajectory \
  --traj-path "data/maniskill2/demos/v0/rigid_body/${ENV_ID}/trajectory.h5" \
  --save-traj --target-control-mode "${CONTROL_MODE}" \
  --obs-mode "${OBS_MODE}" --num-procs "${NPROC}"
