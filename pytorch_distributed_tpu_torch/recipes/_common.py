"""Shared recipe runner, the port of ``pytorch_distributed_tpu/recipes/_common.py``:
parse the flags, apply the recipe's defaults, bootstrap the process group
the launcher names (``parallel/dist.py``), build the trainer and fit.

``launch_per_card`` is the reference's ``mp.spawn`` shape
(``multiprocessing_distributed.py:114``) for the self-launching recipes:
one worker per visible card, each on ``tcp://127.0.0.1:23456``.
"""

from __future__ import annotations

import os
import random
from typing import Callable, Optional

import numpy as np
import torch

from pytorch_distributed_tpu_torch.parallel import DistContext, initialize, shutdown
from pytorch_distributed_tpu_torch.train.config import Config, build_parser, parse_config
from pytorch_distributed_tpu_torch.train.trainer import Trainer

SPAWN_COORDINATOR = "127.0.0.1:23456"


def seed_everything(seed: Optional[int]) -> None:
    """The reference's ``main()`` seeding: Python, numpy and torch."""
    if seed is not None:
        random.seed(seed)
        np.random.seed(seed)
        torch.manual_seed(seed)


def run_recipe(description: str, argv=None, precision_default: Optional[str] = None,
               explicit_collectives: bool = False, grad_compress_default: Optional[str] = None,
               epoch_csv_default: Optional[str] = None, bootstrap: bool = True,
               before_fit: Optional[Callable[[Trainer], None]] = None) -> Trainer:
    """Parse ``argv``, bootstrap (unless ``bootstrap`` is false), build the
    trainer, call ``before_fit`` on it (when given), ``fit``; returns the
    trainer, its process group still up (``finish`` takes it down)."""
    cfg: Config = parse_config(argv, description=description)
    seed_everything(cfg.seed)
    if cfg.precision is None:  # an explicit --precision always wins
        cfg.precision = precision_default or "fp32"
    if cfg.grad_compress is None:  # an explicit --grad-compress always wins
        cfg.grad_compress = grad_compress_default
    if epoch_csv_default is not None and cfg.epoch_csv is None:
        cfg.epoch_csv = epoch_csv_default
    ctx = initialize(device=cfg.device) if bootstrap else DistContext(0, 1, None)
    try:
        trainer = Trainer(cfg, ctx, explicit_collectives=explicit_collectives)
    except BaseException as e:
        shutdown(ctx)
        if isinstance(e, NotImplementedError):  # an arch or layer not ported yet
            raise SystemExit(str(e)) from e
        raise
    if before_fit is not None:
        before_fit(trainer)
    trainer.fit()
    return trainer


def finish(trainer: Trainer) -> float:
    """Take down the trainer's process group; returns its best top-1."""
    shutdown(trainer.ctx)
    return trainer.best_acc1


def _spawned(index: int, main: Callable, argv, world: int) -> None:
    os.environ["PTD_TPU_PROCESS_ID"] = str(index)
    os.environ["PTD_TPU_NUM_PROCESSES"] = str(world)
    main(argv)


def launch_per_card(main: Callable, argv=None):
    """Run ``main(argv)`` once per visible card, as the reference's
    ``mp.spawn`` does: each worker gets ``PTD_TPU_*`` for its rank (the
    coordinator defaults to 127.0.0.1:23456), so a group forms even on one
    card, which runs in this process.  A process that a launcher already
    made a worker (``PTD_TPU_NUM_PROCESSES`` set), and a run on the CPU,
    call ``main`` directly.  Returns ``main``'s result when it ran in this
    process, else None."""
    if "PTD_TPU_NUM_PROCESSES" in os.environ:
        os.environ.setdefault("PTD_TPU_COORDINATOR", SPAWN_COORDINATOR)
        return main(argv)
    device = build_parser().parse_known_args(argv)[0].device
    n = torch.cuda.device_count() if torch.device(device).type == "cuda" else 0
    if n == 0:
        return main(argv)
    os.environ.setdefault("PTD_TPU_COORDINATOR", SPAWN_COORDINATOR)
    if n == 1:
        os.environ["PTD_TPU_PROCESS_ID"], os.environ["PTD_TPU_NUM_PROCESSES"] = "0", "1"
        return main(argv)
    torch.multiprocessing.spawn(_spawned, args=(main, argv, n), nprocs=n)
    return None
