"""Where a checkpoint's save and load time goes, at the LM's full width.

    python -m pytorch_distributed_tpu_torch.tools.profile_checkpoint [--dir DIR] [--repeats N]

Builds the LM that chip_smoke.py trains (vocab 32000, d_model 1024, 16
heads, 12 layers, f32 weights, seeded random weights), takes one SGD step
so every parameter has a momentum buffer, then saves and loads it through
``train/checkpoint.py`` ``--repeats`` times, timing each part with the host
clock (each part that touches the card ends in a synchronise):

- save: the JAX trees on the host (transposes on the card, one
  device-to-host copy per tensor), msgpack encoding (headers only; array
  payloads are views), the file write, the sha256 sidecar;
- load: the read into one buffer, its sha256 (the sidecar check),
  parsing, the copy to the card with its transposes there, and writing the
  weights and momentum into the model and optimizer.

Prints one line per part and repeat, then the file size and the card.  The
file goes under ``--dir`` (default: a temporary directory, deleted after).
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

from pytorch_distributed_tpu_torch.ft.integrity import write_sidecar
from pytorch_distributed_tpu_torch.models.transformer import TransformerLM
from pytorch_distributed_tpu_torch.train import checkpoint as ckpt
from pytorch_distributed_tpu_torch.train.lm import SyntheticTokenDataset, make_lm_train_step
from pytorch_distributed_tpu_torch.train.optim import sgd
from pytorch_distributed_tpu_torch.utils import flax_msgpack
from pytorch_distributed_tpu_torch.utils.device import resolve_device


def _clock(times, name, fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    times[name] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=None, help="where the file goes (default: a temp dir)")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    cfg = dict(vocab_size=32000, d_model=1024, n_heads=16, n_layers=12)
    model = TransformerLM(**cfg, dtype=torch.bfloat16, param_dtype=torch.float32, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    opt = sgd(model.parameters())
    tokens = torch.from_numpy(SyntheticTokenDataset(4, 1024, cfg["vocab_size"]).batch(0, 2))
    make_lm_train_step(model, opt)(tokens.to(dev), 0.01)
    torch.cuda.synchronize()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    directory = args.dir or tempfile.mkdtemp(prefix="profile_checkpoint_")
    path = os.path.join(directory, "part.msgpack")
    try:
        os.makedirs(directory, exist_ok=True)
        for r in range(args.repeats):
            save, load = {}, {}
            state = _clock(save, "trees_to_host", lambda: ckpt.state_trees(model, opt))
            state["step"] = np.asarray(1, np.int32)
            payload = {"epoch": 0, "arch": "transformer_lm", "best_acc1": 0.0,
                       "ft": ckpt._ft_record(None), "state": state}
            parts = _clock(save, "encode", lambda: flax_msgpack.encode_parts(payload))

            def write():
                with open(path, "wb") as f:
                    flax_msgpack.write_parts(parts, f)

            _clock(save, "write", write)
            _clock(save, "sidecar", lambda: write_sidecar(path))
            del state, payload, parts
            raw = _clock(load, "read", lambda: flax_msgpack.read_buffer(path))
            _clock(load, "verify_sha256", lambda: hashlib.sha256(raw).hexdigest())
            tree = _clock(load, "parse", lambda: flax_msgpack.msgpack_restore(raw))
            sd, mom = _clock(load, "to_card", lambda: ckpt._torch_state(
                model, tree["state"], True))

            def apply():
                with torch.no_grad():
                    model.load_state_dict(sd)
                    for name, p in model.named_parameters():
                        opt.state[p]["momentum_buffer"] = torch.empty_like(p).copy_(mom[name])

            _clock(load, "apply", apply)
            del raw, tree, sd, mom
            print(f"[checkpoint profile] repeat {r}: save {sum(save.values())} s "
                  + " ".join(f"{k} {v}" for k, v in save.items())
                  + f"; load {sum(load.values())} s "
                  + " ".join(f"{k} {v}" for k, v in load.items()), flush=True)
        print(f"[checkpoint profile] file {os.path.getsize(path)} bytes, "
              f"{sum(p.numel() for p in model.parameters())} parameters and their momentum; "
              f"card {card}")
    finally:
        if args.dir is None:
            shutil.rmtree(directory, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
