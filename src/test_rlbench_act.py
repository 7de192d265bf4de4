"""RLBench ACT closed-loop evaluation entry.

Reference `src/test_rlbench_act.py:98-245`: launches CoppeliaSim, replays
stored demos for variation selection, CLIP-encodes the task description as
goal conditioning, and rolls the checkpointed ACT policy closed-loop with
temporal aggregation and IK-retry. Success rate is appended to
``result_path/result_file``.

    python src/test_rlbench_act.py exp_rlbench_act_policy=base \\
        exp_rlbench_act_policy/rlbench_model@rlbench_model=scratch_pointnet_pcd \\
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

from pointcloudmatters_tpu.envs.rlbench_eval import run_rlbench_act_eval
from pointcloudmatters_tpu.utils import config as C
from pointcloudmatters_tpu.utils.compile_cache import enable_compile_cache
from pointcloudmatters_tpu.utils import rlbench_utils as RU
from pointcloudmatters_tpu.utils.pylogger import RankedLogger
from pointcloudmatters_tpu.utils.utils import extras, seed_everything, task_wrapper

log = RankedLogger(__name__, rank_zero_only=True)


def build_model_and_state(cfg, trainer_cls=None):
    """Instantiate the task module and restore the checkpoint."""
    from pointcloudmatters_tpu.trainer import Trainer

    datamodule = C.instantiate(cfg.data)
    model = C.instantiate(cfg.model)
    model.seed = cfg.get("seed") or 0
    trainer = (trainer_cls or Trainer)(
        default_root_dir=C.select(cfg, "paths.output_dir") or ".",
        accelerator=C.select(cfg, "trainer.accelerator") or "auto",
        devices=1,
    )
    trainer._module = model
    trainer.datamodule = datamodule
    loader = datamodule.train_dataloader()
    example_batch = next(iter(loader))
    model.setup_module(trainer, example_batch)
    trainer.state = trainer._replicate(model.initial_state(example_batch))
    if cfg.get("ckpt_path"):
        trainer.restore_checkpoint(cfg.ckpt_path)
    return model, trainer, datamodule


def make_convert_obs(cfg, datamodule):
    """obs -> batched policy input, mirroring the dataset pipeline
    (`test_rlbench_act.py:71-94`)."""
    train_ds = datamodule.data_train
    is_pcd = "pcd" in type(train_ds).__name__.lower()
    collision = bool(C.select(cfg, "data.train.collision"))
    task_name = cfg.rlbench_task
    pad_multiple = getattr(datamodule, "pad_multiple", 512)

    def convert(obs):
        data = {
            "qpos": RU.get_qpos_data([obs], task_name, collision)[0][None],
        }
        if is_pcd:
            data["pcds"] = RU.get_pcd(
                [obs], train_ds.cameras, train_ds.transform_pcd,
                use_mask=getattr(train_ds, "use_mask", False),
                pad_multiple=pad_multiple,
            )
        else:
            data["image"] = RU.get_image_data(
                obs, train_ds.cameras, train_ds.include_depth
            )[None]
        return data

    return convert


@task_wrapper
def eval(cfg) -> tuple[dict, dict]:
    if cfg.get("seed"):
        seed_everything(cfg.seed)
    env, task = RU.build_env_and_task(cfg)
    log.info(f"Testing RLBench {cfg.rlbench_task} task...")

    text_encoder = RU.build_text_encoder(cache_path=cfg.get("clip_cache_path"))
    model, trainer, datamodule = build_model_and_state(cfg)
    convert_obs = make_convert_obs(cfg, datamodule)

    import jax

    policy_apply = jax.jit(functools.partial(model.policy.apply, train=False))

    def predict(obs, description):
        data = convert_obs(obs)
        data["goal_cond"] = text_encoder.encode(description).reshape(1, -1)
        variables = {"params": trainer.state.params,
                     "batch_stats": trainer.state.batch_stats}
        out = policy_apply(variables, data)
        return np.asarray(out["a_hat"])[0]

    def reset_fn(ep):
        _, demos, description, obs = RU.reset_task(task, cfg, ep)
        log.info(f"Episode {ep + 1}/{cfg.episodes_num}: {description[0]}")
        return description[0], obs

    success_rate = run_rlbench_act_eval(
        predict=predict, reset_fn=reset_fn, step_fn=task.step,
        task_name=cfg.rlbench_task,
        episodes_num=cfg.episodes_num, max_steps=cfg.max_steps,
        collision=bool(C.select(cfg, "data.train.collision")),
        temporal_agg=bool(C.select(cfg, "temporal_agg.apply")),
        # aggregation happens in 6D-rot space: dim = data.train.action_dim
        agg_action_dim=int(C.select(cfg, "temporal_agg.action_dim") or 11),
        agg_chunk_size=int(C.select(cfg, "temporal_agg.chunk_size") or 16),
        agg_k=float(C.select(cfg, "temporal_agg.k") or 0.01),
    )
    log.info(f"success_rate: {success_rate}")

    os.makedirs(cfg.result_path, exist_ok=True)
    full_path = os.path.join(cfg.result_path, cfg.result_file)
    with open(full_path, "a") as f:
        f.write(f"{cfg.result_name}: {success_rate}\n")
    log.info(f"Results saved to {full_path}")
    env.shutdown()
    return {"success_rate": success_rate}, {"cfg": cfg}


def main(argv: Optional[list[str]] = None):
    enable_compile_cache()
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = C.compose(os.path.join(REPO_ROOT, "configs"), "test_rlbench_act", argv)
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
