"""Train / eval CLI entries (``python -m deadtrees_tpu_torch train|eval``).

Counterpart of ``deadtrees_tpu.train.entry``: the config is composed from
``./configs`` (run from the repo root) with the CLI's ``key=value``
overrides; ``train`` writes into ``run_dir/<date>/<time>`` and saves the
composed tree there; ``eval`` tests ``bestmodel=<checkpoint>`` (with
``tta=4|8`` when given) over the test shards. Both run on CUDA unless
``device="cpu"`` is passed.
"""

from __future__ import annotations

import datetime
import logging
from pathlib import Path
from typing import Optional, Sequence


def _compose(overrides: Sequence[str], config_dir: Optional[Path] = None):
    from deadtrees_tpu_torch.config import compose
    from deadtrees_tpu_torch.utils import load_envs

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
    )
    load_envs()
    config_dir = config_dir or Path.cwd() / "configs"
    return compose(config_dir, "config", overrides=list(overrides))


def train_from_cli(
    overrides: Sequence[str], config_dir: Optional[Path] = None, device: Optional[str] = None
):
    from deadtrees_tpu_torch.config import print_config
    from deadtrees_tpu_torch.train.trainer import train

    cfg = _compose(overrides, config_dir)
    now = datetime.datetime.now()
    run_dir = (
        Path(cfg.get("run_dir", "logs/runs"))
        / now.strftime("%Y-%m-%d")
        / now.strftime("%H-%M-%S")
    )
    run_dir.mkdir(parents=True, exist_ok=True)
    if cfg.get("print_config", True):
        print_config(cfg, save_path=run_dir / "config_tree.log")
    result = train(cfg, work_dir=run_dir, device=device)
    print(result)
    return result


def eval_from_cli(
    overrides: Sequence[str], config_dir: Optional[Path] = None, device: Optional[str] = None
):
    from deadtrees_tpu_torch.config import print_config
    from deadtrees_tpu_torch.train.trainer import Trainer

    cfg = _compose(overrides, config_dir)
    if cfg.get("print_config", True):
        print_config(cfg)
    ckpt = cfg.get("bestmodel")
    if not ckpt:
        raise SystemExit("eval requires bestmodel=<checkpoint path>")
    trainer = Trainer(cfg, device=device)
    trainer._build()
    metrics = trainer.test(ckpt_path=ckpt)
    print(metrics)
    return metrics
