"""Checkpoint save / resume, the port of ``pytorch_distributed_tpu/train/checkpoint.py``.

One file per checkpoint in the JAX package's own format, so a model trained
by either package resumes, samples or serves in the other: flax msgpack
(``utils/flax_msgpack.py``, no flax needed) of

    {"epoch", "arch", "best_acc1", "ft",
     "state": {"batch_stats", "momentum", "params", "step"}}

with the JAX trees (``utils/convert.py``, any arch of the image zoo or the
LM): Dense kernels ``[in, out]``, conv kernels HWIO, BatchNorm statistics in
``batch_stats`` (``{}`` for the LM and the zoo's models without BatchNorm),
the SGD momentum in the params' tree, ``step`` a 0-d int32 array, and keys
sorted as the JAX package's host fetch leaves them.  The torch side takes
the model, the optimizer and the step instead of a ``TrainState``.

Fault tolerance as in JAX (``ft/integrity.py``): the payload goes to a tmp
file and is renamed into place, the previous checkpoint is kept as
``checkpoint.prev.msgpack`` with its sidecar, then the new sha256 sidecar is
written; ``model_best`` gets the same atomic write.  Every write is retried
on ``OSError``.  Loads read the file once and check that buffer against the
sidecar before parsing it, and a corrupt
``checkpoint.msgpack`` falls back to the previous file with a warning.  A
legacy file without a sidecar still loads; if it fails to parse, that is
``CheckpointCorruptError``.  The ``ft`` record (step in epoch, global step,
sampler seed and epoch, LR scale) restores the exact step.

The gradient-communication stack's state (``train/gradsync.py``) rides in
the same layout as in JAX: the error-feedback ``residual`` subtree (stacked
``(n, *shape)`` over the ranks for the explicit step, param-shaped for the
emulation; written only when the run carries one), and under ``--zero wus``
the momentum gathered from the ranks' rows to the param-shaped tree every
checkpoint stores (the quantized gather's error is dropped: it restarts at
zero).  A load restores the residual when its shapes fit the run (the same
mode and world), else starts it at zero, and re-chunks the momentum for a
``wus`` run, so files cross modes both ways; ``meta["has_residual"]`` says
whether the file carried one.

Not ported: the orbax backend, whose ``orbax.checkpoint`` imports JAX (an
orbax directory raises ``NotImplementedError`` with that reason, and
``--ckpt-backend orbax`` exits from ``train/config.py``).
"""

from __future__ import annotations

import hashlib
import os
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch.ft.integrity import (
    CheckpointCorruptError,
    read_sidecar,
    replace_with_sidecar,
    retrying,
    write_sidecar,
)
from pytorch_distributed_tpu_torch.utils import flax_msgpack
from pytorch_distributed_tpu_torch.utils.convert import (
    image_leaves,
    image_params_to_jax,
    image_state_dict_from_jax,
    image_variables_to_jax,
    lm_params_to_jax,
    lm_state_dict_from_jax,
    momentum_state_dict,
)

CHECKPOINT_NAME = "checkpoint.msgpack"
PREV_NAME = "checkpoint.prev.msgpack"
BEST_NAME = "model_best.msgpack"

ORBAX_MESSAGE = ("orbax checkpoints are not ported to the PyTorch package: "
                 "orbax.checkpoint imports JAX, so the port reads and writes the "
                 "msgpack format only (--ckpt-backend msgpack, a checkpoint file, not a "
                 "directory)")

# Data-iterator / FT state stored alongside the model state: enough to
# restore the exact step.  ``step`` is the step-in-epoch offset (0 = "this
# epoch is complete; resume starts the next one"); the sampler's (seed,
# epoch) pair regenerates the identical permutation, so no index lists are
# stored.
FT_DEFAULTS: Dict[str, Any] = {
    "step": 0,
    "global_step": 0,
    "sampler_seed": 0,
    "sampler_epoch": 0,
    "lr_scale": 1.0,
}


def _ft_record(ft: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Normalize a (possibly partial/absent) ft dict to the canonical
    schema with plain-python values msgpack/json can carry."""
    out = dict(FT_DEFAULTS)
    for k, v in (ft or {}).items():
        if k not in FT_DEFAULTS:
            raise ValueError(f"unknown ft checkpoint field {k!r}; expected "
                             f"one of {sorted(FT_DEFAULTS)}")
        out[k] = float(v) if k == "lr_scale" else int(v)
    return out


def _is_lm(state_dict) -> bool:
    """The TransformerLM (``embed.weight``); anything else is an image model
    of the zoo, whose JAX leaf table ``utils/convert.py`` holds."""
    return "embed.weight" in state_dict


def _paths(tree, prefix=()) -> set:
    if isinstance(tree, dict):
        return set().union(*[_paths(v, prefix + (k,)) for k, v in tree.items()]) if tree else set()
    return {prefix}


def _check_fits(model: torch.nn.Module, saved: Dict[str, Any]) -> None:
    """An image checkpoint's ``params`` and ``batch_stats`` hold exactly the
    leaves of ``model``'s JAX trees (another arch, or another depth of the
    same family, raises)."""
    leaves = image_leaves(model)
    for col, want in (("params", {leaf.path for leaf in leaves if not leaf.is_stat}),
                      ("batch_stats", {leaf.path for leaf in leaves if leaf.is_stat})):
        got = _paths(saved.get(col) or {})
        if got != want:
            raise ValueError(f"checkpoint does not fit the model: {col} missing "
                             f"{sorted('/'.join(p) for p in want - got)[:4]}, unexpected "
                             f"{sorted('/'.join(p) for p in got - want)[:4]}")


def state_trees(model: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer]
                ) -> Dict[str, Any]:
    """The JAX ``TrainState`` trees of ``model`` and its SGD ``optimizer``:
    ``{"batch_stats", "momentum", "params"}`` as host f32 numpy."""
    sd = model.state_dict()
    momentum = momentum_state_dict(model, optimizer)
    if _is_lm(sd):
        return {"batch_stats": {}, "momentum": lm_params_to_jax(momentum),
                "params": lm_params_to_jax(sd)}
    v = image_variables_to_jax(model, sd)
    return {"batch_stats": v["batch_stats"], "momentum": image_params_to_jax(model, momentum),
            "params": v["params"]}


def save_checkpoint(
    directory: str,
    model: torch.nn.Module,
    optimizer: Optional[torch.optim.Optimizer],
    step: int,
    epoch: int,
    arch: str,
    best_acc1: float,
    is_best: bool,
    ft: Optional[Dict[str, Any]] = None,
    momentum: Optional[Dict[str, Any]] = None,
    residual: Optional[Dict[str, Any]] = None,
) -> str:
    """Atomic save of ``model``, the momentum of ``optimizer`` and the
    global ``step`` (the reference's rank-0 ``save_checkpoint``, one
    process here); returns the path.

    ``momentum`` / ``residual``: JAX-layout trees that replace the
    optimizer's momentum and add the error-feedback residual
    (``GradSync.checkpoint_trees``, which every rank computes first).

    ``ft``: optional step-granular resume record (see ``FT_DEFAULTS``);
    omitted fields default to the epoch-boundary semantics.  Write
    discipline: payload to tmp + rename, the previous checkpoint rotated to
    ``checkpoint.prev.msgpack`` (with its sidecar) first, then the new
    sidecar, so the directory always holds one complete, verifiable
    checkpoint; the sequence is retried with bounded backoff on OSError."""
    state = state_trees(model, optimizer)
    if momentum is not None:
        state["momentum"] = momentum
    if residual:
        state["residual"] = residual
    state["step"] = np.asarray(step, np.int32)
    payload = {
        "epoch": int(epoch),
        "arch": arch,
        "best_acc1": float(best_acc1),
        "ft": _ft_record(ft),
        "state": state,
    }
    parts = flax_msgpack.encode_parts(payload)
    path = os.path.join(directory, CHECKPOINT_NAME)

    def write() -> str:
        os.makedirs(directory, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            flax_msgpack.write_parts(parts, f)
        if os.path.exists(path):
            # Retain N=2: the outgoing latest becomes the fallback the
            # loader reaches for when the new file turns out corrupt.
            replace_with_sidecar(path, os.path.join(directory, PREV_NAME))
        os.replace(tmp, path)
        write_sidecar(path)
        return path

    retrying(write)
    if is_best:
        best = os.path.join(directory, BEST_NAME)

        def write_best() -> None:
            tmp = best + ".tmp"
            with open(tmp, "wb") as f:
                flax_msgpack.write_parts(parts, f)
            os.replace(tmp, best)
            write_sidecar(best)

        retrying(write_best)
    return path


def _read_verified(path: str) -> Tuple[bytearray, bool]:
    """The file in one buffer, checked against its sha256 sidecar before
    anything parses it: ``(buffer, True)`` on a match, ``(buffer, False)``
    with no sidecar (a legacy file), ``CheckpointCorruptError`` on a
    mismatch.  The digest is of the very bytes that will be parsed, in one
    read of the file."""
    raw = retrying(lambda: flax_msgpack.read_buffer(path))
    want = read_sidecar(path)
    if want is None:
        return raw, False
    got = hashlib.sha256(raw).hexdigest()
    if got != want:
        raise CheckpointCorruptError(
            f"checkpoint '{path}' fails sha256 sidecar verification (expected {want}, "
            f"file hashes to {got}): corrupted or truncated on disk")
    return raw, True


def read_payload(path: str) -> Dict[str, Any]:
    """Verify the sidecar (when there is one) and decode the whole payload;
    arrays are views into one buffer of the file."""
    if os.path.isdir(path):
        raise NotImplementedError(ORBAX_MESSAGE)
    return flax_msgpack.msgpack_restore(_read_verified(path)[0])


def _torch_state(model: torch.nn.Module, saved: Dict[str, Any], with_momentum: bool
                 ) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, torch.Tensor]]]:
    """The saved JAX trees as ``state_dict`` tensors on the model's device
    (each array copied there once, then transposed there), checked against
    the model's names and shapes before anything is written into it."""
    device = next(model.parameters()).device
    want = model.state_dict()
    if _is_lm(want):
        sd = lm_state_dict_from_jax(saved["params"], device=device)
        mom = lm_state_dict_from_jax(saved["momentum"], device=device) if with_momentum else None
    else:
        _check_fits(model, saved)
        sd = image_state_dict_from_jax(model, saved["params"], saved["batch_stats"] or {},
                                       device=device)
        mom = (image_state_dict_from_jax(model, saved["momentum"], None, device=device)
               if with_momentum else None)
    for got, names in ((sd, set(want)), (mom, {n for n, _ in model.named_parameters()})):
        if got is None:
            continue
        if set(got) != names:
            raise ValueError(f"checkpoint does not fit the model: missing "
                             f"{sorted(names - set(got))[:4]}, unexpected "
                             f"{sorted(set(got) - names)[:4]}")
        bad = [n for n in got if tuple(got[n].shape) != tuple(want[n].shape)]
        if bad:
            raise ValueError(f"checkpoint does not fit the model: {bad[0]} is "
                             f"{tuple(got[bad[0]].shape)}, the model's "
                             f"{tuple(want[bad[0]].shape)}")
    return sd, mom


def _load_msgpack(path: str, model: torch.nn.Module,
                  optimizer: Optional[torch.optim.Optimizer], comm=None
                  ) -> Tuple[int, Dict[str, Any]]:
    """Verify-then-deserialize one msgpack checkpoint file into ``model``
    (and ``optimizer``'s momentum, or ``comm``'s rows of it under ``wus``,
    and ``comm``'s residual).  Corruption surfaces as
    ``CheckpointCorruptError``; a verified file that does not fit the model
    raises as it is (an arch mismatch, not corruption)."""
    raw, verified = _read_verified(path)
    wus = comm is not None and comm.wus
    try:
        tree = flax_msgpack.msgpack_restore(raw)
        saved = dict(tree["state"])
        residual = saved.pop("residual", None)
        sd, mom = _torch_state(model, saved, optimizer is not None and not wus)
        step = int(np.asarray(saved["step"]))
        meta = {
            "epoch": int(tree["epoch"]),
            "arch": str(tree["arch"]),
            "best_acc1": float(tree["best_acc1"]),
            "ft": _ft_record(tree.get("ft")),
            "has_residual": bool(residual),
        }
    except CheckpointCorruptError:
        raise
    except Exception as e:
        if verified:
            raise
        raise CheckpointCorruptError(
            f"checkpoint '{path}' failed to deserialize and carries no "
            f"sha256 sidecar to pinpoint corruption: {e}") from e
    with torch.no_grad():
        model.load_state_dict(sd)
        if optimizer is not None and not wus:
            for name, p in model.named_parameters():
                optimizer.state[p]["momentum_buffer"] = torch.empty_like(p).copy_(mom[name])
    if comm is not None:
        comm.load(saved["momentum"] if wus else None, residual)
    del raw, tree, saved
    return step, meta


def load_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    fallback: bool = True, comm=None) -> Tuple[int, Dict[str, Any]]:
    """Restore a checkpoint file into ``model`` (and the momentum buffers of
    ``optimizer``, when given; ``comm``: the train step's ``GradSync``,
    which takes the residual and, under ``wus``, the momentum); returns
    ``(step, meta)``, meta carrying epoch / arch / best_acc1, the ``ft``
    record and ``has_residual``.

    ``fallback``: when the latest ``checkpoint.msgpack`` fails sidecar
    verification (or a legacy file fails to parse), resume continues from
    the retained ``checkpoint.prev.msgpack``; only when both are bad does
    ``CheckpointCorruptError`` propagate."""
    if os.path.isdir(path):
        raise NotImplementedError(ORBAX_MESSAGE)
    try:
        return _load_msgpack(path, model, optimizer, comm)
    except CheckpointCorruptError as e:
        prev = None
        if os.path.basename(path) == CHECKPOINT_NAME:
            prev = os.path.join(os.path.dirname(path), PREV_NAME)
        if fallback and prev and os.path.exists(prev):
            warnings.warn(f"latest checkpoint is corrupt; falling back to '{prev}' ({e})",
                          stacklevel=2)
            return _load_msgpack(prev, model, optimizer, comm)
        raise
