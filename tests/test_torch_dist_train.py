"""Data-parallel image training in the port at two gloo ranks on the CPU,
against the JAX package's steps on a 2-device CPU mesh.

One module fixture starts two rank processes once (``PTD_TPU_*``, the
bootstrap of ``parallel/dist.py``) and runs every multi-rank case in them;
the tests read its results.  Each case feeds the same three global batches
(8 samples, or 32 where noted; the last quarter padded out, so the ranks'
weight counts differ) and the same tiny Bottleneck ResNet weights; rank r
takes the r-th half of each, as the JAX mesh shards the global batch.  f32.

- GSPMD twin (DDP, global-batch BatchNorm, ``accum_steps=2``,
  ``log_norms``, ``guard_nonfinite``), fused (K4/K5's plain versions) and
  unfused, against the JAX ``make_train_step`` (GSPMD ``global_step``;
  Pallas in interpret mode): the tolerances of PERF.md's 3-image-step row,
  metrics rtol 1e-4, weights and statistics atol 1e-4, rtol 1e-3 (summation
  order: each rank's moments and gradient sums are partial sums of the
  global ones).
- The bf16 cases against the JAX steps with ``grad_compress="bf16"``: the
  explicit twin (``explicit_collectives=True``) without accumulation at
  batch 8 and with ``accum_steps=2`` at batch 32 (per-rank strided
  microbatches of 8: its BatchNorm is per rank, and microbatches of 2
  samples, some of them padding, make a chaotic map that carries one bf16
  ulp of step 1 into another trajectory by step 2, on both sides alike),
  and the GSPMD twin's numerics emulation at batch 32 (global microbatches
  of 16).  The wire itself is read from the first step's momentum buffer
  (the synced gradient plus ``1e-4 * w``): nearly every element must be
  the same f32 number as JAX's (``test_first_update_carries_the_jax_bf16_rounding``;
  an f32 wire, a cast after the division, or the emulation left out fails
  it).  After three steps each rank's local gradient sums, rounded to bf16
  before the sum, can differ from JAX's by order in their last f32 bits and
  round to a neighbouring bf16 value: one bf16 ulp, 2**-8 of the gradient.
  Weights: atol 2e-3 of their largest magnitude plus rtol 2**-8 * 4 (one
  ulp of each of three steps' updates, carried by momentum 0.9); metrics
  rtol 2e-3.
- World 2 against world 1 in the port (the GSPMD twin on one process),
  the 3-image-step tolerances.
- ``multiprocessing_distributed`` for one epoch at two ranks: disjoint
  sampler shards, the same metrics on both ranks, one checkpoint written by
  rank 0 only, gloo chosen.
- The gradient-communication stack (batch 8; buckets of 0.01 MiB): the f32
  ZeRO steps (explicit, deferred gather, GSPMD twin) and the f32 bucketed
  explicit step against JAX's at the 3-image-step tolerances; int8 and fp8
  (explicit, bucketed, ZeRO, the GSPMD emulation) at metrics rtol 2e-3 and
  99% of all elements within 2e-3 of their tensor's largest + 2**-6
  relative, every element within 5e-2 of it (an element at a rounding
  boundary may quantize one level apart, and training carries it); their
  first update on JAX's quantization levels (99% within 2**-16 of the
  tensor's largest, where a level is at least 2**-8 of a block's);
  bucketed and f32 ZeRO bitwise equal to their plain twins; each ZeRO
  rank's momentum the JAX chunk layout's row.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.models import resnet as jr
from pytorch_distributed_tpu.ops import qcomm as jq
from pytorch_distributed_tpu.parallel import MeshSpec, build_mesh
from pytorch_distributed_tpu.parallel import overlap as jo
from pytorch_distributed_tpu.parallel import zero as jz
from pytorch_distributed_tpu.train.optim import sgd_init
from pytorch_distributed_tpu.train.state import TrainState
from pytorch_distributed_tpu.train.steps import make_train_step as jax_train_step
from pytorch_distributed_tpu_torch.models import resnet as tr
from pytorch_distributed_tpu_torch.parallel import zero
from pytorch_distributed_tpu_torch.train.optim import sgd
from pytorch_distributed_tpu_torch.train.steps import make_train_step
from pytorch_distributed_tpu_torch.utils.convert import resnet_state_dict_from_jax
from tests.test_torch_zoo import FAST_COMPILE

QUANTIZED_COMPILE = {"xla_llvm_disable_expensive_passes": True}

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(stage_sizes=[1, 1], num_classes=7, num_filters=16)
LRS = (0.1, 0.05, 0.02)
CASES = {"gspmd_fused": dict(fused=True, explicit=False, wire=None, accum=2, batch=8),
         "gspmd_unfused": dict(fused=False, explicit=False, wire=None, accum=2, batch=8),
         "gspmd_bf16": dict(fused=False, explicit=False, wire="bf16", accum=2, batch=32),
         "explicit_bf16": dict(fused=False, explicit=True, wire="bf16", accum=1, batch=8),
         "explicit_bf16_accum": dict(fused=False, explicit=True, wire="bf16", accum=2,
                                     batch=32),
         "explicit_sync_bn": dict(fused=False, explicit=True, wire=None, accum=1, batch=8,
                                  sync_bn=True)}
# The gradient-communication stack: quantized wires, ZeRO weight-update
# sharding and bucketed overlap (buckets of 0.01 MiB: ~10 over the tiny
# ResNet's 29 leaves).
A9 = dict(fused=False, accum=1, batch=8)
CASES.update({
    "explicit_f32": dict(A9, explicit=True, wire=None),
    "explicit_f32_bucketed": dict(A9, explicit=True, wire=None, overlap="bucketed"),
    "explicit_int8": dict(A9, explicit=True, wire="int8"),
    "explicit_fp8": dict(A9, explicit=True, wire="fp8"),
    "explicit_int8_bucketed": dict(A9, explicit=True, wire="int8", overlap="bucketed"),
    "explicit_wus": dict(A9, explicit=True, wire=None, zero="wus"),
    "explicit_wus_int8": dict(A9, explicit=True, wire="int8", zero="wus"),
    "explicit_wus_bucketed_deferred": dict(A9, explicit=True, wire=None, zero="wus",
                                           overlap="bucketed", wus_gather="deferred"),
    "gspmd_int8": dict(A9, explicit=False, wire="int8", accum=2),
    "gspmd_wus": dict(A9, explicit=False, wire=None, zero="wus", accum=2),
})
BUCKET_MB = 0.01
WIRE_CASES = sorted(k for k, c in CASES.items() if c["wire"] == "bf16")
QUANTIZED_CASES = sorted(k for k, c in CASES.items() if c["wire"] in ("int8", "fp8"))
A9_F32_CASES = sorted(k for k, c in CASES.items()
                      if c["wire"] is None and (c.get("zero") or c.get("overlap")))

WORKER = r'''
import os, sys
import torch
rank, out, port, port2 = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
os.environ.update(PTD_TPU_COORDINATOR=f"127.0.0.1:{port}", PTD_TPU_NUM_PROCESSES="2",
                  PTD_TPU_PROCESS_ID=str(rank))
from pytorch_distributed_tpu_torch.models import resnet as tr
from pytorch_distributed_tpu_torch.parallel import initialize, shutdown
from pytorch_distributed_tpu_torch.recipes import multiprocessing_distributed as mpd
from pytorch_distributed_tpu_torch.train import trainer as trainer_mod
from pytorch_distributed_tpu_torch.train.gradsync import momentum_bytes
from pytorch_distributed_tpu_torch.train.optim import sgd
from pytorch_distributed_tpu_torch.train.steps import make_train_step
from pytorch_distributed_tpu_torch.utils.convert import resnet_state_dict_from_jax

inp = torch.load(os.path.join(out, "inputs.pt"))
ctx = initialize(device="cpu")
res = {"backend": ctx.backend, "rank": ctx.process_index, "world": ctx.process_count}
for name, case in inp["cases"].items():
    model = tr.ResNet(block_cls=tr.Bottleneck, fused_convbn=case["fused"], device="cpu",
                      **inp["tiny"])
    model.load_state_dict(inp["state"])
    opt = sgd(model.parameters())
    step = make_train_step(model, opt, accum_steps=case["accum"],
                           log_norms=True, guard_nonfinite=True, group=ctx.group,
                           explicit_collectives=case["explicit"], grad_compress=case["wire"],
                           sync_bn=case.get("sync_bn", False), zero=case.get("zero", "none"),
                           overlap=case.get("overlap", "none"), bucket_mb=inp["bucket_mb"],
                           wus_gather=case.get("wus_gather", "eager"))
    comm = step.comm
    metrics, half = [], case["batch"] // 2
    for b, lr in zip(inp["batches"][case["batch"]], inp["lrs"]):
        local = {k: v[half * rank:half * (rank + 1)] for k, v in b.items()}
        metrics.append({k: float(v) for k, v in step(local, lr).items()})
        if len(metrics) == 1:  # the first step's buffer: the synced gradient + wd * w
            if comm is not None and comm.wus:  # gathered from the ranks' rows
                momentum1 = resnet_state_dict_from_jax(comm.checkpoint_trees()["momentum"], None)
            else:
                momentum1 = {n: opt.state[p]["momentum_buffer"].clone()
                             for n, p in model.named_parameters()}
    if comm is not None:
        comm.materialize()  # a deferred gather's last delta
    res[name] = {"metrics": metrics, "state": dict(model.state_dict()), "momentum1": momentum1,
                 "momentum_numel": momentum_bytes(opt, comm) // 4,
                 "buckets": len(comm.buckets) if comm is not None else None}
shutdown(ctx)

# One recipe epoch at two ranks, through its own bootstrap.
os.environ["PTD_TPU_COORDINATOR"] = f"127.0.0.1:{port2}"
saves, trainers = [], []
real_save, real_finish = trainer_mod.save_checkpoint, mpd.finish
trainer_mod.save_checkpoint = lambda *a, **k: saves.append(real_save(*a, **k)) or saves[-1]
mpd.finish = lambda t: trainers.append(t) or real_finish(t)
mpd.main(["--device", "cpu", "--synthetic", "--synthetic-length", "32", "-a", "resnet18",
          "--image-size", "32", "--num-classes", "4", "-b", "16", "--epochs", "1", "-p", "1",
          "--seed", "0", "--checkpoint-dir", os.path.join(out, "ckpt"),
          "--epoch-csv", os.path.join(out, f"epochs{rank}.csv")])
t = trainers[0]
t.train_sampler.set_epoch(0)
res["recipe"] = {"backend": t.ctx.backend, "shard": [int(i) for i in t.train_sampler],
                 "local_batch": t.local_batch, "losses": [float(x) for x in t.losses],
                 "eval": t.eval_history, "saves": saves}
torch.save(res, os.path.join(out, f"rank{rank}.pt"))
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _batches(n=3, batch=8, seed=4):
    """``n`` global batches, the last quarter of each padded out."""
    rng = np.random.default_rng(seed)
    weights = np.array([1.0] * (batch - batch // 4) + [0.0] * (batch // 4), np.float32)
    return [{"images": rng.normal(size=(batch, 8, 8, 3)).astype(np.float32),
             "labels": rng.integers(0, 7, size=batch).astype(np.int32),
             "weights": weights} for _ in range(n)]


def _jax_run(variables, batches, fused, accum=2, sync_bn=False, zero="none",
             wus_gather="eager", **kw):
    mesh = build_mesh(MeshSpec(("data",), (2,)), jax.devices()[:2])
    jm = jr.ResNet(block_cls=jr.Bottleneck, fused_convbn=fused,
                   bn_axis_name="data" if sync_bn else None, **TINY)
    v = jax.tree_util.tree_map(jnp.asarray, variables)
    mode, explicit = kw.get("grad_compress") or "none", kw["explicit_collectives"]
    momentum = sgd_init(v["params"])
    if zero == "wus" and explicit:
        momentum = jz.init_wus_momentum(v["params"], 2, quantized=mode in ("int8", "fp8"))
        if wus_gather == "deferred":
            momentum["pending"] = jo.init_pending(v["params"], 2)
    residual = jq.init_residual(v["params"], mode, explicit=explicit, n_data=2)
    state = TrainState.create(v, momentum, residual=residual)
    jstep = jax_train_step(jm, mesh, accum_steps=accum, log_norms=True, guard_nonfinite=True,
                           zero=zero, wus_gather=wus_gather, params=v["params"],
                           bucket_mb=BUCKET_MB, **kw)

    def param_shaped(momentum, params):
        if jz.is_wus_momentum(momentum):
            return jz.gather_momentum(momentum, params)
        return momentum

    metrics = []
    for b, rate in zip(batches, LRS):
        b = {k: jnp.asarray(x) for k, x in b.items()}
        if not metrics:
            # The quantized steps keep XLA's HLO passes: which element sits
            # at a rounding boundary depends on how XLA fuses them.  Only
            # LLVM's expensive passes go, which leaves every number of
            # these cases bitwise as the default compile gives it.
            jstep = jstep.lower(state, b, jnp.float32(rate)).compile(
                QUANTIZED_COMPILE if mode in ("int8", "fp8") else FAST_COMPILE)
        state, m = jstep(state, b, jnp.float32(rate))
        metrics.append({k: float(x) for k, x in m.items()})
        if len(metrics) == 1:
            host = jax.device_get(state)
            momentum1 = resnet_state_dict_from_jax(param_shaped(host.momentum, host.params),
                                                   None)
    host = jax.device_get(state)
    params = host.params
    if wus_gather == "deferred":
        params = jo.materialize_params(params, host.momentum["pending"])
    return {"metrics": metrics, "momentum1": momentum1,
            "state": resnet_state_dict_from_jax(params, host.batch_stats)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the two ranks, compute the JAX and world-1 references while
    they run, and collect everything."""
    out = tmp_path_factory.mktemp("dist")
    jm = jr.ResNet(block_cls=jr.Bottleneck, **TINY)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init, static_argnames="train")(
        jax.random.PRNGKey(7), jnp.zeros((1, 8, 8, 3)), train=False))
    batches = {8: _batches(), 32: _batches(batch=32, seed=5)}
    state = resnet_state_dict_from_jax(variables["params"], variables["batch_stats"])
    torch.save({"state": state, "lrs": LRS, "tiny": TINY, "cases": CASES, "bucket_mb": BUCKET_MB,
                "batches": {n: [{k: torch.from_numpy(v) for k, v in b.items()} for b in bs]
                            for n, bs in batches.items()}},
               out / "inputs.pt")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PTD_TPU", "SLURM_", "RANK", "WORLD_SIZE", "LOCAL_", "MASTER_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    ports = [str(_free_port()), str(_free_port())]
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(out), *ports],
                              env=env, cwd=str(out), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        want = {name: _jax_run(variables, batches[c["batch"]], c["fused"], accum=c["accum"],
                               sync_bn=c.get("sync_bn", False), zero=c.get("zero", "none"),
                               wus_gather=c.get("wus_gather", "eager"),
                               overlap=c.get("overlap", "none"),
                               explicit_collectives=c["explicit"], grad_compress=c["wire"])
                for name, c in CASES.items()}
        model = tr.ResNet(block_cls=tr.Bottleneck, device="cpu", **TINY)
        model.load_state_dict(state)
        step = make_train_step(model, sgd(model.parameters()), accum_steps=2, log_norms=True,
                               guard_nonfinite=True)
        world1 = ([{k: float(x) for k, x in step({k: torch.from_numpy(v) for k, v in b.items()},
                                                 rate).items()}
                   for b, rate in zip(batches[8], LRS)], dict(model.state_dict()))
        logs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-3000:]}"
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return {"ranks": ranks, "want": want, "world1": world1, "out": out, "logs": logs}


def _close(got_metrics, got_state, want_metrics, want_state, mrtol, atol, rtol, scale=False):
    assert [sorted(g) for g in got_metrics] == [sorted(w) for w in want_metrics]
    for g, w in zip(got_metrics, want_metrics):
        assert g["nonfinite"] == w["nonfinite"] == 0.0
        np.testing.assert_allclose([g[k] for k in sorted(g)], [w[k] for k in sorted(w)],
                                   rtol=mrtol, atol=1e-6)
    for name, t in got_state.items():
        want = want_state[name].numpy()
        a = atol * max(float(np.abs(want).max()), 1e-6) if scale else atol
        np.testing.assert_allclose(t.numpy(), want, atol=a, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("case", ["gspmd_fused", "gspmd_unfused"])
def test_gspmd_twin_matches_jax_two_device_step(runs, case):
    want = runs["want"][case]
    for rank in runs["ranks"]:
        _close(rank[case]["metrics"], rank[case]["state"], want["metrics"], want["state"],
               mrtol=1e-4, atol=1e-4, rtol=1e-3)


def test_explicit_sync_bn_matches_jax_bn_axis_name(runs):
    """``--sync-bn`` on the explicit step (f32): BatchNorm over both ranks'
    batch through ``set_bn_group``, against the JAX explicit step with
    ``bn_axis_name``; the 3-image-step tolerances, as the GSPMD twin's."""
    want = runs["want"]["explicit_sync_bn"]
    for rank in runs["ranks"]:
        _close(rank["explicit_sync_bn"]["metrics"], rank["explicit_sync_bn"]["state"],
               want["metrics"], want["state"], mrtol=1e-4, atol=1e-4, rtol=1e-3)


def _close_bf16(runs, case):
    """Three steps with a bf16 rounding in each: one bf16 ulp of each
    step's update."""
    want = runs["want"][case]
    for rank in runs["ranks"]:
        _close(rank[case]["metrics"], rank[case]["state"], want["metrics"], want["state"],
               mrtol=2e-3, atol=2e-3, rtol=4 * 2.0 ** -8, scale=True)


def test_explicit_bf16_wire_matches_jax_explicit_step(runs):
    """Without accumulation, and with it (per-rank strided microbatches of 8)."""
    for case in ("explicit_bf16", "explicit_bf16_accum"):
        _close_bf16(runs, case)


def test_gspmd_bf16_matches_jax_emulation(runs):
    _close_bf16(runs, "gspmd_bf16")


@pytest.mark.parametrize("case", WIRE_CASES)
def test_first_update_carries_the_jax_bf16_rounding(runs, case):
    """The wire itself.  The first step's momentum buffer is the synced
    gradient plus ``1e-4 * w`` (it starts at zero), so it shows which values
    were rounded to bf16 and where: the local sums before the sum (explicit)
    or the averaged gradient (GSPMD).  Both sides round the same f32 values
    up to their summation order, so nearly every element is the same f32
    number (within 2**-20 of itself, the optimizer's own rounding); only
    one that sits at a bf16 rounding boundary may take the neighbouring
    value, which moves it by one bf16 ulp of a local sum over the count.
    An f32 wire, or a cast after dividing by the count, moves nearly every
    element by up to half a bf16 ulp and fails the first bound."""
    want = runs["want"][case]["momentum1"]
    for rank in runs["ranks"]:
        got, same, total = rank[case]["momentum1"], 0, 0
        for name, w in want.items():
            g, w = got[name].numpy(), w.numpy()
            err = np.abs(g - w)
            same += int((err <= 2.0 ** -20 * np.abs(w)).sum())
            total += w.size
            assert err.max() <= 2.0 ** -6 * np.abs(w).max(), name
        assert same >= 0.99 * total, f"{same} of {total} elements equal"
@pytest.mark.parametrize("case", ["gspmd_fused", "gspmd_unfused"])
def test_world_two_matches_world_one(runs, case):
    metrics, state = runs["world1"]
    rank0 = runs["ranks"][0][case]
    _close(rank0["metrics"], rank0["state"], metrics, state, mrtol=1e-4, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ranks_end_identical(runs, case):
    """Both ranks end with the same weights, statistics and metrics."""
    r0, r1 = (r[case] for r in runs["ranks"])
    assert r0["metrics"] == r1["metrics"]
    for name, t in r0["state"].items():
        assert torch.equal(t, r1["state"][name]), name


def test_bootstrap_chose_gloo_and_ranks(runs):
    assert [(r["backend"], r["rank"], r["world"]) for r in runs["ranks"]] == [
        ("gloo", 0, 2), ("gloo", 1, 2)]
    assert all(r["recipe"]["backend"] == "gloo" for r in runs["ranks"])


def test_recipe_sampler_shards_are_disjoint(runs):
    shards = [r["recipe"]["shard"] for r in runs["ranks"]]
    assert len(shards[0]) == len(shards[1]) == 16
    assert not set(shards[0]) & set(shards[1])
    assert sorted(shards[0] + shards[1]) == list(range(32))
    assert [r["recipe"]["local_batch"] for r in runs["ranks"]] == [8, 8]


def test_recipe_metrics_equal_on_both_ranks(runs):
    r0, r1 = (r["recipe"] for r in runs["ranks"])
    assert len(r0["losses"]) == 2 and r0["losses"] == r1["losses"]
    assert len(r0["eval"]) == 1 and r0["eval"] == r1["eval"]


def test_recipe_checkpoint_written_by_rank_zero_only(runs):
    saves = [r["recipe"]["saves"] for r in runs["ranks"]]
    assert len(saves[0]) == 1 and saves[1] == []
    ckpt = runs["out"] / "ckpt"
    assert sorted(p.name for p in ckpt.iterdir() if p.suffix == ".msgpack") == [
        "checkpoint.msgpack", "model_best.msgpack"] or sorted(
        p.name for p in ckpt.iterdir() if p.suffix == ".msgpack") == ["checkpoint.msgpack"]
    assert (runs["out"] / "epochs0.csv").exists() and not (runs["out"] / "epochs1.csv").exists()
    assert "Epoch: [0]" in runs["logs"][0] and "Epoch: [0]" not in runs["logs"][1]


@pytest.mark.parametrize("case", A9_F32_CASES)
def test_f32_zero_and_bucketed_cases_match_jax(runs, case):
    """f32 ZeRO (explicit and GSPMD twin, deferred gather included) and the
    bucketed explicit step against the JAX steps with the same modes: the
    3-image-step tolerances, as the plain steps."""
    want = runs["want"][case]
    for rank in runs["ranks"]:
        _close(rank[case]["metrics"], rank[case]["state"], want["metrics"], want["state"],
               mrtol=1e-4, atol=1e-4, rtol=1e-3)


def _close_quantized(got_metrics, got_state, want_metrics, want_state):
    """Three steps with int8 or fp8 sync.  Each side's local gradient sums
    differ from the other's by summation order, so an element at a rounding
    boundary may quantize one step apart; training then amplifies it.  The
    metrics agree to 2e-3 (relative), 99% of all elements to the bf16 row's
    atol 2e-3 of their tensor's largest + rtol 2**-6, every element to 5e-2
    of its tensor's largest."""
    assert [sorted(g) for g in got_metrics] == [sorted(w) for w in want_metrics]
    for g, w in zip(got_metrics, want_metrics):
        assert g["nonfinite"] == w["nonfinite"] == 0.0
        np.testing.assert_allclose([g[k] for k in sorted(g)], [w[k] for k in sorted(w)],
                                   rtol=2e-3, atol=1e-6)
    near = total = 0
    for name, t in got_state.items():
        got, want = t.numpy(), want_state[name].numpy()
        top = max(float(np.abs(want).max()), 1e-6)
        err = np.abs(got - want)
        near += int((err <= 2e-3 * top + 2.0 ** -6 * np.abs(want)).sum())
        total += want.size
        assert err.max() <= 5e-2 * top, name
    assert near >= 0.99 * total, f"{near} of {total} elements near"


@pytest.mark.parametrize("case", QUANTIZED_CASES)
def test_quantized_cases_match_jax(runs, case):
    """int8 and fp8: the explicit step's EQuARX all-reduce (monolithic and
    bucketed), ZeRO over the quantized reduce-scatter and all-gather, and the
    GSPMD twin's emulation, against JAX's 2-device steps."""
    want = runs["want"][case]
    for rank in runs["ranks"]:
        _close_quantized(rank[case]["metrics"], rank[case]["state"], want["metrics"],
                         want["state"])


@pytest.mark.parametrize("case", QUANTIZED_CASES)
def test_first_update_carries_the_jax_quantization(runs, case):
    """The wire itself: the first step's momentum buffer is the synced
    gradient plus ``1e-4 * w``, a quantization level times its block's
    scale.  Both sides quantize the same local sums (explicit) or averaged
    gradient (GSPMD) up to summation order, which moves a scale by a few
    ulps, so nearly every element sits on JAX's level: within 2**-16 of its
    tensor's largest, where a level is at least 2**-8 of a block's largest
    (int8: 1/127; fp8 e4m3: 1/448 at the top, coarser relative below); an
    element at a rounding boundary may take the neighbouring level.  An f32
    wire, or one quantization where JAX quantizes twice, moves nearly every
    element off its level and fails the count."""
    want = runs["want"][case]["momentum1"]
    for rank in runs["ranks"]:
        got, same, total = rank[case]["momentum1"], 0, 0
        for name, w in want.items():
            g, w = got[name].numpy(), w.numpy()
            err = np.abs(g - w)
            same += int((err <= 2.0 ** -16 * np.abs(w).max()).sum())
            total += w.size
            assert err.max() <= 2.0 ** -4 * np.abs(w).max(), name
        assert same >= 0.99 * total, f"{same} of {total} elements on JAX's level"


@pytest.mark.parametrize("plain,twin", [("explicit_f32", "explicit_f32_bucketed"),
                                        ("explicit_int8", "explicit_int8_bucketed"),
                                        ("explicit_f32", "explicit_wus"),
                                        ("gspmd_unfused", "gspmd_wus")])
def test_bucketed_and_f32_zero_equal_their_plain_twins_bitwise(runs, plain, twin):
    """At two ranks a sum has one order, and the bucketed and ZeRO stages do
    per element what the plain ones do: the same bits of the weights,
    statistics and metrics.  The gradient norm alone is reduced in another
    order under ZeRO (each rank's chunks, then over the ranks, as in JAX):
    rtol 1e-6."""
    for rank in runs["ranks"]:
        a, b = rank[plain], rank[twin]
        for ma, mb in zip(a["metrics"], b["metrics"]):
            assert {k: v for k, v in ma.items() if k != "grad_norm"} == \
                {k: v for k, v in mb.items() if k != "grad_norm"}
            assert ma["grad_norm"] == pytest.approx(mb["grad_norm"], rel=1e-6)
        for name, t in a["state"].items():
            assert torch.equal(t, b["state"][name]), name


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c].get("zero") == "wus"])
def test_zero_momentum_is_one_chunk_of_the_jax_layout_per_rank(runs, case):
    """Each rank holds its row: ``chunk_layout``'s chunk of every leaf at 2
    ranks, half of the replicated momentum plus the padding."""
    model = tr.ResNet(block_cls=tr.Bottleneck, device="cpu", **TINY)
    sizes = [p.numel() for p in model.parameters()]
    want = sum(zero.chunk_size(n, 2) for n in sizes)
    assert want == sum(jz.chunk_size(n, 2) for n in sizes)
    for rank in runs["ranks"]:
        assert rank[case]["momentum_numel"] == want
    assert want <= sum(sizes) / 2 + 2 * len(sizes) * 256


def test_bucketed_cases_make_several_buckets(runs):
    for case in ("explicit_f32_bucketed", "explicit_int8_bucketed",
                 "explicit_wus_bucketed_deferred"):
        assert runs["ranks"][0][case]["buckets"] > 3
