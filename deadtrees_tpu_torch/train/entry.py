"""Train / eval CLI entries (``python -m deadtrees_tpu_torch train|eval``).

Counterpart of ``deadtrees_tpu.train.entry``: the config is composed from
``./configs`` (run from the repo root) with the CLI's ``key=value``
overrides; ``train`` writes into ``run_dir/<date>/<time>`` and saves the
composed tree there; ``eval`` tests ``bestmodel=<checkpoint>`` (with
``tta=4|8`` when given) over the test shards. Both run on CUDA unless
``device="cpu"`` is passed.

Under a launcher that names a world size above 1 (``python -m
torch.distributed.run --nproc-per-node N -m deadtrees_tpu_torch train
trainer.devices=N ...``) both join the process group first
(``parallel.mesh.distributed_init``): NCCL on CUDA, gloo on the CPU, or
the ``backend`` asked for (gloo puts several ranks on one card). Every
rank writes into rank 0's run directory.
"""

from __future__ import annotations

import datetime
import logging
from pathlib import Path
from typing import Optional, Sequence


def _join_group(device: Optional[str], backend: Optional[str]) -> bool:
    """Join the launcher's process group when it names several processes."""
    from deadtrees_tpu_torch.parallel.mesh import distributed_init, env_world_size

    if env_world_size() <= 1:
        return False
    if backend is None and device is not None and str(device).startswith("cpu"):
        backend = "gloo"
    return distributed_init(backend=backend)


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
    overrides: Sequence[str], config_dir: Optional[Path] = None, device: Optional[str] = None,
    backend: Optional[str] = None,
):
    from deadtrees_tpu_torch.config import print_config
    from deadtrees_tpu_torch.parallel.mesh import rank0_value
    from deadtrees_tpu_torch.train.trainer import train

    several = _join_group(device, backend)
    cfg = _compose(overrides, config_dir)
    now = datetime.datetime.fromtimestamp(rank0_value(datetime.datetime.now().timestamp()))
    run_dir = (
        Path(cfg.get("run_dir", "logs/runs"))
        / now.strftime("%Y-%m-%d")
        / now.strftime("%H-%M-%S")
    )
    run_dir.mkdir(parents=True, exist_ok=True)
    if cfg.get("print_config", True) and not (several and _rank() != 0):
        print_config(cfg, save_path=run_dir / "config_tree.log")
    result = train(cfg, work_dir=run_dir, device=device)
    print(result)
    return result


def eval_from_cli(
    overrides: Sequence[str], config_dir: Optional[Path] = None, device: Optional[str] = None,
    backend: Optional[str] = None,
):
    from deadtrees_tpu_torch.config import print_config
    from deadtrees_tpu_torch.train.trainer import Trainer

    several = _join_group(device, backend)
    cfg = _compose(overrides, config_dir)
    if cfg.get("print_config", True) and not (several and _rank() != 0):
        print_config(cfg)
    ckpt = cfg.get("bestmodel")
    if not ckpt:
        raise SystemExit("eval requires bestmodel=<checkpoint path>")
    trainer = Trainer(cfg, device=device)
    trainer._build()
    metrics = trainer.test(ckpt_path=ckpt)
    print(metrics)
    return metrics


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank()
