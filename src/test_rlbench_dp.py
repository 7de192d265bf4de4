"""RLBench diffusion-policy closed-loop evaluation entry.

Reference `src/test_rlbench_dp.py`: like the ACT eval but with an
``n_obs_steps`` observation history and every predicted action executed
before re-planning.

    python src/test_rlbench_dp.py exp_rlbench_diffusion_policy=base \\
        exp_rlbench_diffusion_policy/rlbench_model@rlbench_model=scratch_pointnet_pcd \\
        rlbench_task=close_jar ckpt_path=...
"""

from __future__ import annotations

import functools
import os
import sys
from typing import Optional

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

import numpy as np

from pointcloudmatters_tpu.envs.rlbench_eval import run_rlbench_dp_eval
from pointcloudmatters_tpu.utils import config as C
from pointcloudmatters_tpu.utils.compile_cache import enable_compile_cache
from pointcloudmatters_tpu.utils import rlbench_utils as RU
from pointcloudmatters_tpu.utils.pylogger import RankedLogger
from pointcloudmatters_tpu.utils.utils import extras, seed_everything, task_wrapper
from src.test_rlbench_act import build_model_and_state

log = RankedLogger(__name__, rank_zero_only=True)


@task_wrapper
def eval(cfg) -> tuple[dict, dict]:
    if cfg.get("seed"):
        seed_everything(cfg.seed)
    env, task = RU.build_env_and_task(cfg)
    log.info(f"Testing RLBench {cfg.rlbench_task} task (diffusion policy)...")

    text_encoder = RU.build_text_encoder(cache_path=cfg.get("clip_cache_path"))
    model, trainer, datamodule = build_model_and_state(cfg)
    train_ds = datamodule.data_train
    is_pcd = "pcd" in type(train_ds).__name__.lower()
    collision = bool(C.select(cfg, "data.train.collision"))
    n_obs_steps = int(model.policy.n_obs_steps)
    pad_multiple = getattr(datamodule, "pad_multiple", 512)

    import jax

    policy_apply = jax.jit(functools.partial(model.policy.apply, train=False))
    sample_key = jax.random.PRNGKey(cfg.get("seed") or 0)
    counter = dict(n=0)

    def predict(hist_obs, description):
        obs_dict = {
            "qpos": RU.get_qpos_data(
                hist_obs, cfg.rlbench_task, collision
            )[None],  # (1, To, D)
        }
        if is_pcd:
            obs_dict["pcds"] = RU.get_pcd(
                hist_obs, train_ds.cameras, train_ds.transform_pcd,
                use_mask=getattr(train_ds, "use_mask", False),
                n_obs_steps=n_obs_steps, pad_multiple=pad_multiple,
            )
        else:
            obs_dict["front_rgb"] = np.stack([
                RU.get_image_data(o, train_ds.cameras, False)[0]
                for o in hist_obs
            ])[None]
        data = {
            "obs": obs_dict,
            "goal": {"task_emb": text_encoder.encode(description).reshape(1, -1)},
        }
        variables = {"params": trainer.state.params,
                     "batch_stats": trainer.state.batch_stats}
        counter["n"] += 1
        out = policy_apply(
            variables, data,
            rngs={"sample": jax.random.fold_in(sample_key, counter["n"])},
        )
        return np.asarray(out["action"])[0]

    def reset_fn(ep):
        _, demos, description, obs = RU.reset_task(task, cfg, ep)
        log.info(f"Episode {ep + 1}/{cfg.episodes_num}: {description[0]}")
        return description[0], obs

    success_rate = run_rlbench_dp_eval(
        predict=predict, reset_fn=reset_fn, step_fn=task.step,
        task_name=cfg.rlbench_task, n_obs_steps=n_obs_steps,
        episodes_num=cfg.episodes_num, max_steps=cfg.max_steps,
        collision=collision,
    )
    log.info(f"success_rate: {success_rate}")
    os.makedirs(cfg.result_path, exist_ok=True)
    full_path = os.path.join(cfg.result_path, cfg.result_file)
    with open(full_path, "a") as f:
        f.write(f"{cfg.result_name}: {success_rate}\n")
    env.shutdown()
    return {"success_rate": success_rate}, {"cfg": cfg}


def main(argv: Optional[list[str]] = None):
    enable_compile_cache()
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = C.compose(os.path.join(REPO_ROOT, "configs"), "test_rlbench_dp", argv)
    C.set_runtime(cwd=os.getcwd(), output_dir="<pending>")
    hydra_cfg = cfg.get("hydra") or {}
    run_dir_tpl = C.select(hydra_cfg, "run.dir") or "outputs"
    probe = C.DotDict(C.to_container(cfg))
    output_dir = os.path.abspath(str(C._Resolver(probe).resolve_str(str(run_dir_tpl))))
    os.makedirs(output_dir, exist_ok=True)
    C.set_runtime(output_dir=output_dir, cwd=os.getcwd())
    C.resolve_config(cfg)
    extras(cfg)
    metric_dict, _ = eval(cfg)
    return metric_dict


if __name__ == "__main__":
    main()
