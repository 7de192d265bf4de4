"""Evaluation entry point: load a checkpoint, run validation.

Same CLI contract as the reference (`src/validate.py:89-103`) — composes
``configs/train.yaml`` with overrides and requires ``ckpt_path=...``. For
ManiSkill2 modules this runs the closed-loop simulator rollout protocol;
for RLBench modules it computes held-out loss.
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
    instantiate_loggers,
    seed_everything,
    task_wrapper,
)

log = RankedLogger(__name__, rank_zero_only=True)


@task_wrapper
def validate(cfg) -> tuple[dict, dict]:
    assert cfg.get("ckpt_path"), "validate.py requires ckpt_path=..."
    if cfg.get("seed") is not None:
        seed_everything(cfg.seed)

    log.info("Instantiating datamodule...")
    datamodule = C.instantiate(cfg.data)
    log.info("Instantiating model...")
    model = C.instantiate(cfg.model)
    model.seed = cfg.get("seed") or 0
    loggers = instantiate_loggers(cfg.get("logger"))
    log.info("Instantiating trainer...")
    trainer = C.instantiate(cfg.trainer, callbacks=[], logger=loggers)

    object_dict = {"cfg": cfg, "datamodule": datamodule, "model": model,
                   "logger": loggers, "trainer": trainer}
    log.info("Starting validation!")
    metric_dict = trainer.validate(
        model, datamodule=datamodule, ckpt_path=cfg.ckpt_path
    )
    log.info(f"Validation metrics: {metric_dict}")
    return metric_dict, object_dict


def main(argv: Optional[list[str]] = None):
    enable_compile_cache()
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = C.compose(os.path.join(REPO_ROOT, "configs"), "train", argv)
    C.set_runtime(cwd=os.getcwd(), output_dir="<pending>")
    hydra_cfg = cfg.get("hydra") or {}
    run_dir_tpl = C.select(hydra_cfg, "run.dir") or "outputs"
    probe = C.DotDict(C.to_container(cfg))
    run_dir = C._Resolver(probe).resolve_str(str(run_dir_tpl))
    output_dir = os.path.abspath(str(run_dir))
    os.makedirs(output_dir, exist_ok=True)
    C.set_runtime(output_dir=output_dir, cwd=os.getcwd())
    C.resolve_config(cfg)
    extras(cfg)
    metric_dict, _ = validate(cfg)
    return metric_dict


if __name__ == "__main__":
    main()
