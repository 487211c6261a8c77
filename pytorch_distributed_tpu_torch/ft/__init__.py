"""Fault tolerance of the PyTorch port (mirrors pytorch_distributed_tpu/ft).

Ported: ``integrity.py`` (the checkpoint sidecars, atomic writes and I/O
retries of ``train/checkpoint.py``), ``chaos.py`` (the deterministic fault
injectors and their ``chaos=`` hooks in both trainers and the serving
engine, with ``utils/preempt.py``'s SIGTERM guard), ``divergence.py``
(``DivergenceGuard``, the skip/rollback policy over the step's
``nonfinite`` flag, and ``StateKeeper``, the host-memory last-good
snapshot; ``--nan-guard`` / ``--ft-*`` in both trainers) and ``elastic.py``
(membership epochs, the file-based coordinator the fleet arbiter drives,
the rescale rules and the exact re-grids).  The trainers' ``--elastic``
re-mesh and the rest of ``scripts/chaoskit.py`` wait for ROADMAP.md item
A11.

The names below load their module on first use, and none of these modules
imports torch at import time, so the fleet's processes load ``ft``
without torch.
"""

import importlib

_EXPORTS = {
    "ChaosInjector": "chaos", "ChaosSchedule": "chaos", "DelayRank": "chaos",
    "HangAt": "chaos", "KillAt": "chaos", "LRSpikeAt": "chaos", "NaNBatchAt": "chaos",
    "SignalAt": "chaos", "SlowLoader": "chaos", "corrupt_file": "chaos",
    "DivergenceGuard": "divergence", "StateKeeper": "divergence",
    "ElasticCoordinator": "elastic", "ElasticSim": "elastic", "JoinRankAt": "elastic",
    "LoseRankAt": "elastic", "Membership": "elastic", "MembershipChange": "elastic",
    "regrid_stacked_residual": "elastic", "regrid_wus_momentum": "elastic",
    "rescale_batch": "elastic", "rescale_lr": "elastic",
    "CheckpointCorruptError": "integrity", "check_integrity": "integrity",
    "file_sha256": "integrity", "read_sidecar": "integrity",
    "replace_with_sidecar": "integrity", "retrying": "integrity",
    "sidecar_path": "integrity", "verify_sidecar": "integrity",
    "write_sidecar": "integrity",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
