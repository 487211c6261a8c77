"""Shared recipe runner, the port of ``pytorch_distributed_tpu/recipes/_common.py``
for one device (the multi-process bootstrap waits for ROADMAP.md item A18)."""

from __future__ import annotations

import random
from typing import Optional

import numpy as np
import torch

from pytorch_distributed_tpu_torch.train.config import Config, parse_config
from pytorch_distributed_tpu_torch.train.trainer import Trainer


def seed_everything(seed: Optional[int]) -> None:
    """The reference's ``main()`` seeding: Python, numpy and torch."""
    if seed is not None:
        random.seed(seed)
        np.random.seed(seed)
        torch.manual_seed(seed)


def run_recipe(description: str, argv=None, precision_default: Optional[str] = None,
               epoch_csv_default: Optional[str] = None) -> Trainer:
    """Parse ``argv``, build the trainer, ``fit``; returns the trainer."""
    cfg: Config = parse_config(argv, description=description)
    seed_everything(cfg.seed)
    if cfg.precision is None:  # an explicit --precision always wins
        cfg.precision = precision_default or "fp32"
    if epoch_csv_default is not None and cfg.epoch_csv is None:
        cfg.epoch_csv = epoch_csv_default
    try:
        trainer = Trainer(cfg)
    except NotImplementedError as e:  # an arch or layer not ported yet
        raise SystemExit(str(e)) from e
    trainer.fit()
    return trainer
