"""Training entry point.

Same CLI contract as the reference (`src/train.py:116`):

    python src/train.py exp_maniskill2_act_policy=base \
        exp_maniskill2_act_policy/maniskill2_model@maniskill2_model=scratch_pointnet_pcd \
        exp_maniskill2_act_policy/maniskill2_pcd_task@maniskill2_pcd_task=PickCube-v0 \
        debug=default data.train.dataset_file=...

Overrides use the Hydra grammar implemented by
``pointcloudmatters_tpu.utils.config``; composition root is
``configs/train.yaml``.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from pointcloudmatters_tpu.utils import config as C
from pointcloudmatters_tpu.utils.compile_cache import enable_compile_cache
from pointcloudmatters_tpu.utils.pylogger import RankedLogger
from pointcloudmatters_tpu.utils.utils import (
    extras,
    get_metric_value,
    instantiate_callbacks,
    instantiate_loggers,
    log_hyperparameters,
    seed_everything,
    task_wrapper,
)

log = RankedLogger(__name__, rank_zero_only=True)


@task_wrapper
def train(cfg) -> tuple[dict, dict]:
    """(reference `src/train.py:46-113`)"""
    if cfg.get("seed") is not None:
        seed_everything(cfg.seed)

    log.info("Instantiating datamodule...")
    datamodule = C.instantiate(cfg.data)

    log.info("Instantiating model...")
    model = C.instantiate(cfg.model)
    model.seed = cfg.get("seed") or 0

    callbacks = instantiate_callbacks(cfg.get("callbacks"))
    loggers = instantiate_loggers(cfg.get("logger"))

    log.info("Instantiating trainer...")
    trainer = C.instantiate(cfg.trainer, callbacks=callbacks, logger=loggers)

    object_dict = {
        "cfg": cfg, "datamodule": datamodule, "model": model,
        "callbacks": callbacks, "logger": loggers, "trainer": trainer,
    }

    metric_dict: dict = {}
    if cfg.get("train", True):
        log.info("Starting training!")
        trainer.fit(model, datamodule=datamodule, ckpt_path=cfg.get("ckpt_path"))
        log_hyperparameters(object_dict)
        metric_dict.update(model.train_metrics.compute())
        metric_dict.update(model.best_val_metrics.compute())

    if cfg.get("test"):
        log.info("Starting testing!")
        ckpt = None
        if trainer.checkpoint_callback is not None:
            ckpt = trainer.checkpoint_callback.best_model_path or None
        if ckpt is None:
            log.warning("Best ckpt not found! Using current weights for testing...")
        metric_dict.update(
            trainer.validate(model, datamodule=datamodule, ckpt_path=ckpt)
        )

    return metric_dict, object_dict


def _resolve_dir_template(cfg, template: str) -> str:
    # hydra would create the templated run dir; we do the same. The template
    # is resolved against a throwaway copy (paths.output_dir itself refers to
    # the runtime value being computed here).
    probe = C.DotDict(C.to_container(cfg))
    return os.path.abspath(str(C._Resolver(probe).resolve_str(str(template))))


def _run_one(argv: list[str], output_dir: Optional[str] = None) -> Optional[float]:
    cfg = C.compose(os.path.join(REPO_ROOT, "configs"), "train", argv)
    C.set_runtime(cwd=os.getcwd(), output_dir="<pending>")
    if output_dir is None:
        hydra_cfg = cfg.get("hydra") or {}
        run_dir_tpl = C.select(hydra_cfg, "run.dir") or "outputs"
        output_dir = _resolve_dir_template(cfg, run_dir_tpl)
    os.makedirs(output_dir, exist_ok=True)
    C.set_runtime(output_dir=output_dir, cwd=os.getcwd())

    C.resolve_config(cfg)
    extras(cfg)
    metric_dict, _ = train(cfg)
    return get_metric_value(metric_dict, cfg.get("optimized_metric"))


def main(argv: Optional[list[str]] = None) -> Optional[float]:
    enable_compile_cache()
    argv = list(sys.argv[1:] if argv is None else argv)
    multirun = False
    for flag in ("-m", "--multirun"):
        while flag in argv:
            argv.remove(flag)
            multirun = True
    if not multirun:
        return _run_one(argv)

    # hydra -m: expand comma choice-sweeps into the job product and run the
    # jobs sequentially under hydra.sweep.dir/<job_idx>
    # (reference `/root/reference/README.md:360-366,477-494`)
    jobs = C.expand_multirun(argv)
    cfg0 = C.compose(os.path.join(REPO_ROOT, "configs"), "train", jobs[0])
    C.set_runtime(cwd=os.getcwd(), output_dir="<pending>")
    sweep_tpl = C.select(cfg0.get("hydra") or {}, "sweep.dir") or "multirun"
    sweep_dir = _resolve_dir_template(cfg0, sweep_tpl)
    log.info(f"multirun: {len(jobs)} job(s) under {sweep_dir}")
    result: Optional[float] = None
    for i, job in enumerate(jobs):
        log.info(f"multirun job {i}/{len(jobs)}: {' '.join(job)}")
        result = _run_one(job, output_dir=os.path.join(sweep_dir, str(i)))
    return result


if __name__ == "__main__":
    main()
