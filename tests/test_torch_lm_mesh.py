"""LM training across ranks in the port (data parallelism, Megatron tensor
parallelism, FSDP and their ``data × model`` composition, the gradient
stack and the fused CE head's mesh variants, ``tp_generate``), at gloo ranks
on the CPU, against the JAX package's steps on a CPU mesh of the same shape.

One module fixture starts four rank processes once (``PTD_TPU_*``, the
bootstrap of ``parallel/dist.py``) and runs every multi-rank case in them:
the 4-rank cases over all four, each 2-rank case over one pair of ranks
(the pairs run side by side).  Every case feeds the same three global
batches of numpy-seeded tokens (8 rows of 16) and the same weights, made by
the JAX ``TransformerLM.init`` and crossed by ``utils/convert.py``; rank r
takes its data index's contiguous rows, as the JAX mesh shards the batch.
The model has 3 heads of 8 (vocab 64, width 24, 2 layers), so at ``--tp 2``
the heads split 2 + 1, a shape GSPMD runs.  f32.

Tolerances (PERF.md §2): the 3-LM-step row (metrics rtol 1e-5; weights atol
2e-5, rtol 1e-4: summation order, partial sums over ranks and shards
carried by momentum) for every f32 case; the A9 two-rank row for int8
(metrics rtol 2e-3, 99% of elements within 2e-3 of their tensor's largest
+ 2**-6 relative, all within 5e-2: a block at a rounding boundary
quantizes one level apart).  Checkpoints crossing meshes, and greedy
tokens, are exact.
"""

import contextlib
import io
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from pytorch_distributed_tpu.models.generate import tp_generate as jax_tp_generate
from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.ops import qcomm as jq
from pytorch_distributed_tpu.parallel import MeshSpec, build_mesh
from pytorch_distributed_tpu.parallel.fsdp import fsdp_specs
from pytorch_distributed_tpu.parallel.tp import replicated_like, shard_state, tp_specs
from pytorch_distributed_tpu.parallel.zero import zero_momentum_specs
from pytorch_distributed_tpu.train import checkpoint as jax_ckpt
from pytorch_distributed_tpu.train import lm as jax_lm
from pytorch_distributed_tpu.train.optim import sgd_init
from pytorch_distributed_tpu.train.state import TrainState
from pytorch_distributed_tpu_torch.models.transformer import lm_shapes
from pytorch_distributed_tpu_torch.parallel import tp as tp_lib
from pytorch_distributed_tpu_torch.parallel.fsdp import fsdp_dims
from pytorch_distributed_tpu_torch.recipes import lm_generate, lm_pretrain
from pytorch_distributed_tpu_torch.utils.convert import lm_state_dict_from_jax
from tests.test_torch_zoo import FAST_COMPILE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=64, d_model=24, n_heads=3, n_layers=2)
SEQ, BATCH = 16, 8
LRS = (0.05, 0.04, 0.03)
NORMS = dict(log_norms=True, clip_grad_norm=0.5)
# pair: which two ranks run a 2-rank case (0: ranks 0-1, 1: ranks 2-3).
CASES = {
    "dp2": dict(dp=2, tp=1, pair=0, kw=dict(NORMS, accum_steps=2)),
    "tp2": dict(dp=1, tp=2, pair=1, kw=dict(NORMS)),
    "fsdp2": dict(dp=2, tp=1, pair=0, fsdp=True, kw=dict(NORMS)),
    "dp2_tp2": dict(dp=2, tp=2, kw=dict(NORMS, accum_steps=2)),
    "dp2_tp2_fsdp": dict(dp=2, tp=2, fsdp=True, kw=dict(NORMS)),
    "dp2_wus": dict(dp=2, tp=1, pair=1, kw=dict(NORMS, zero="wus")),
    "dp2_tp2_wus": dict(dp=2, tp=2, kw=dict(NORMS, zero="wus")),
    "dp2_wus_bf16": dict(dp=2, tp=1, pair=0, kw=dict(NORMS, zero="wus", grad_compress="bf16")),
    "dp2_wus_int8": dict(dp=2, tp=1, pair=1, kw=dict(NORMS, zero="wus", grad_compress="int8")),
    "dp2_tp2_wus_int8": dict(dp=2, tp=2, kw=dict(NORMS, zero="wus", grad_compress="int8")),
    "dp2_int8": dict(dp=2, tp=1, pair=0, kw=dict(log_norms=True, grad_compress="int8")),
    "dp2_bucketed_int8": dict(dp=2, tp=1, pair=1, kw=dict(overlap="bucketed", bucket_mb=0.001,
                                                          grad_compress="int8")),
    "tp2_int8": dict(dp=1, tp=2, pair=0, kw=dict(log_norms=True, grad_compress="int8")),
    "dp2_fused_dp": dict(dp=2, tp=1, pair=0, kw=dict(fused_ce_chunks=2, fused_ce_mode="dp")),
    "tp2_fused_tp": dict(dp=1, tp=2, pair=1, kw=dict(fused_ce_chunks=2, fused_ce_mode="tp")),
}
QUANTIZED = ("dp2_int8", "dp2_bucketed_int8", "tp2_int8", "dp2_wus_int8", "dp2_tp2_wus_int8")
RECIPE = ["--device", "cpu", "--vocab", "64", "--d-model", "24", "--n-heads", "3",
          "--n-layers", "2", "--seq-len", "16", "-b", "8", "--steps", "3", "-p", "1",
          "--no-eval", "--precision", "fp32", "--lr", "0.05", "--seed", "0"]
GEN = ["--device", "cpu", "--random-init", "--vocab", "64", "--d-model", "24", "--n-heads",
       "3", "--n-layers", "2", "--prompt-tokens", "5,9,3,7", "-n", "8"]

WORKER = r'''
import contextlib, io, os, sys
import torch
import torch.distributed as dist
rank, out, port, port2, port3 = int(sys.argv[1]), sys.argv[2], *sys.argv[3:6]
torch.set_num_threads(1)
os.environ.update(PTD_TPU_COORDINATOR=f"127.0.0.1:{port}", PTD_TPU_NUM_PROCESSES="4",
                  PTD_TPU_PROCESS_ID=str(rank))
from pytorch_distributed_tpu_torch.models.generate import tp_generate
from pytorch_distributed_tpu_torch.models.transformer import TransformerLM
from pytorch_distributed_tpu_torch.parallel import DistContext, initialize, shutdown
from pytorch_distributed_tpu_torch.parallel.fsdp import apply_fsdp
from pytorch_distributed_tpu_torch.parallel.mesh import MeshSpec, build_mesh
from pytorch_distributed_tpu_torch.recipes import lm_generate, lm_pretrain
from pytorch_distributed_tpu_torch.train import lm
from pytorch_distributed_tpu_torch.train.gradsync import momentum_bytes
from pytorch_distributed_tpu_torch.train.optim import sgd

inp = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
ctx4 = initialize(device="cpu")
pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
pair = rank // 2
ctx2 = DistContext(rank % 2, 2, ctx4.coordinator, 0, "gloo", pairs[pair])
res = {"backend": ctx4.backend}


def model_on(dp, tp, ctx, fsdp=False):
    mesh = build_mesh(MeshSpec(("data", "model"), (dp, tp)), ctx)
    model = TransformerLM(**inp["cfg"], device="cpu", mesh=mesh)
    if fsdp:
        apply_fsdp(model, mesh)
    return mesh, model.load_full_state_dict(inp["state"])


for name, case in inp["cases"].items():
    if case["dp"] * case["tp"] == 4:
        ctx = ctx4
    elif case["pair"] == pair:
        ctx = ctx2
    else:
        continue
    mesh, model = model_on(case["dp"], case["tp"], ctx, case.get("fsdp", False))
    opt = sgd(model.parameters())
    step = lm.make_lm_train_step(model, opt, mesh=mesh, **case["kw"])
    B, dp, d = inp["batch"], case["dp"], mesh.index("data")
    metrics = []
    for toks, rate in zip(inp["batches"], inp["lrs"]):
        metrics.append({k: float(v) for k, v in
                        step(toks[d * B // dp:(d + 1) * B // dp], rate).items()})
    full = model.full_state_dict()
    trees = step.comm.checkpoint_trees() if step.comm is not None else {}
    res[name] = {"metrics": metrics, "state": full if mesh.is_primary else None,
                 "residual": trees.get("residual") if mesh.is_primary else None,
                 "param_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
                 "momentum_bytes": momentum_bytes(opt, step.comm)}

# Checkpoints across meshes: the JAX file into TP 2 and into FSDP 2; TP 2's
# own file (written by its rank 0 after steps 5 and 6) into DP 2 and FSDP 2.
ds = lm.SyntheticTokenDataset(64, inp["seq"], inp["cfg"]["vocab_size"], seed=0)
fsdp = pair == 0
mesh, model = model_on(2 if fsdp else 1, 1 if fsdp else 2, ctx2, fsdp)
t = lm.LMTrainer(model, ds, inp["batch"], lr=0.05, resume=inp["jax_ckpt"], mesh=mesh)
trees = t._checkpoint_trees()
res["from_jax"] = trees if mesh.is_primary else None
if not fsdp:
    t.checkpoint_dir = os.path.join(out, "ck_tp")
    t.fit(7, print_freq=100)
    trees = t._checkpoint_trees()
    res["tp_saved"] = trees if mesh.is_primary else None
dist.barrier(group=ctx4.group)
for name, kw in (("to_dp", {}), ("to_fsdp", {"fsdp": True})):
    if pair == 0:
        mesh, model = model_on(2, 1, ctx2, **kw)
        t = lm.LMTrainer(model, ds, inp["batch"], lr=0.05,
                         resume=os.path.join(out, "ck_tp", "checkpoint.msgpack"), mesh=mesh)
        trees = t._checkpoint_trees()
        if not kw:
            trees["params"] = lm.lm_params_to_jax(model.state_dict())
            trees["momentum"] = lm.lm_params_to_jax(lm.momentum_state_dict(model, t.optimizer))
        res[name] = trees if mesh.is_primary else None

# tp_generate at TP 2 (ranks 2-3).
if pair == 1:
    mesh, model = model_on(1, 2, ctx2)
    res["tokens"] = tp_generate(model, torch.tensor(inp["prompt"]), 8).tolist()
shutdown(ctx4)

# The recipes through their own bootstrap, at two ranks.
if rank < 2:
    os.environ.update(PTD_TPU_COORDINATOR=f"127.0.0.1:{port2}", PTD_TPU_NUM_PROCESSES="2",
                      PTD_TPU_PROCESS_ID=str(rank))
    t = lm_pretrain.run(inp["recipe"] + ["--tp", "2", "--checkpoint-dir",
                                         os.path.join(out, "rck")])
    res["recipe"] = {"losses": [float(x) for x in t.losses], "backend": t.ctx.backend,
                     "mesh": t.mesh.shape}
    shutdown(t.ctx)
    os.environ["PTD_TPU_COORDINATOR"] = f"127.0.0.1:{port3}"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        lm_generate.main(inp["gen"] + ["--tp", "2"])
    res["gen_out"] = buf.getvalue()
torch.save(res, os.path.join(out, f"rank{rank}.pt"))
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_case(params, batches, case):
    """The JAX step on a ``data × model`` CPU mesh of the case's shape."""
    dp, tp, kw = case["dp"], case["tp"], dict(case["kw"])
    mesh = build_mesh(MeshSpec(("data", "model"), (dp, tp)), jax.devices()[:dp * tp])
    model = JaxLM(**CFG, dtype=jnp.float32)
    p = jax.tree_util.tree_map(jnp.array, params)
    specs = tp_specs(p) if tp > 1 else replicated_like(p)
    if case.get("fsdp"):
        specs = fsdp_specs(p, mesh, base_specs=specs)
    mode = kw.get("grad_compress") or "none"
    explicit = kw.get("overlap") == "bucketed"
    state = TrainState.create({"params": p}, sgd_init(p),
                              residual=jq.init_residual(p, mode, explicit=explicit, n_data=dp))
    mom_specs = (zero_momentum_specs(p, mesh, base_specs=specs) if kw.get("zero") == "wus"
                 else None)
    with mesh:
        state = shard_state(state, specs, mesh, momentum_specs=mom_specs)
        if explicit and mode != "none":
            state = state.replace(residual=jax.device_put(state.residual,
                                                          NamedSharding(mesh, P("data"))))
        step = jax_lm.make_lm_train_step(model, mesh, specs, params=p, **kw)
        metrics = []
        for toks, rate in zip(batches, LRS):
            toks = jax.device_put(jnp.asarray(toks), NamedSharding(mesh, P("data", None)))
            if not metrics:
                step = step.lower(state, toks, jnp.float32(rate)).compile(FAST_COMPILE)
            state, m = step(state, toks, jnp.float32(rate))
            metrics.append({k: float(x) for k, x in m.items()})
    return metrics, jax.device_get(state.params), jax.device_get(state.residual)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the four ranks, compute the JAX references and the world-1
    recipe runs while they run, and collect everything."""
    out = tmp_path_factory.mktemp("lm_mesh")
    params = jax.tree_util.tree_map(np.asarray, jax.jit(JaxLM(**CFG).init)(
        jax.random.PRNGKey(3), jnp.zeros((1, SEQ), jnp.int32))["params"])
    rng = np.random.default_rng(11)
    batches = [rng.integers(0, 64, size=(BATCH, SEQ)).astype(np.int32) for _ in LRS]
    # A JAX checkpoint with a momentum that is not zero, for the loads.
    momentum = jax.tree_util.tree_map(
        lambda x: rng.normal(size=x.shape).astype(np.float32), params)
    jstate = TrainState.create({"params": params}, momentum)
    jax_ckpt.save_checkpoint(str(out / "jax"), jstate, 0, "transformer_lm", 0.0,
                             is_best=False, ft={"step": 5, "global_step": 5})
    prompt = np.array([[5, 9, 3, 7]], np.int32)
    torch.save({"state": lm_state_dict_from_jax(params), "cfg": CFG, "cases": CASES,
                "batch": BATCH, "seq": SEQ, "lrs": LRS, "prompt": prompt,
                "batches": [torch.from_numpy(b) for b in batches],
                "jax_ckpt": str(out / "jax" / "checkpoint.msgpack"),
                "recipe": RECIPE, "gen": GEN}, out / "inputs.pt")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PTD_TPU", "SLURM_", "RANK", "WORLD_SIZE", "LOCAL_", "MASTER_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    ports = [str(_free_port()) for _ in range(3)]
    logs = [open(out / f"log{r}", "w") for r in range(4)]
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(out), *ports],
                              env=env, cwd=str(out), stdout=logs[r],
                              stderr=subprocess.STDOUT, text=True) for r in range(4)]
    try:
        want = {name: _jax_case(params, batches, c) for name, c in CASES.items()}
        mesh2 = build_mesh(MeshSpec(("model",), (2,)), jax.devices()[:2])
        tokens = np.asarray(jax_tp_generate(params, jnp.asarray(prompt), 8, mesh=mesh2,
                                            vocab_size=64, d_model=24, n_heads=3, n_layers=2,
                                            dtype=jnp.float32))
        world1 = lm_pretrain.run(RECIPE)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            lm_generate.main(GEN)
        # A rank that fails leaves the others waiting in a collective: stop
        # them all at the first failure.
        deadline = time.monotonic() + 400
        while time.monotonic() < deadline and any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            p.kill()
            p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (f"rank {r} exited {p.returncode}:\n"
                                   f"{(out / f'log{r}').read_text()[-3000:]}")
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(4)]
    return {"ranks": ranks, "want": want, "params": params, "jstate": jstate,
            "tokens": tokens, "out": out, "world1": [float(x) for x in world1.losses],
            "gen1": buf.getvalue()}


def _first(runs, name):
    """The case's record of the first rank of its mesh."""
    case = CASES[name]
    return runs["ranks"][0 if case["dp"] * case["tp"] == 4 else 2 * case["pair"]][name]


def _ranks_of(runs, name):
    case = CASES[name]
    if case["dp"] * case["tp"] == 4:
        return runs["ranks"]
    return runs["ranks"][2 * case["pair"]:2 * case["pair"] + 2]


@pytest.mark.parametrize("case", sorted(k for k in CASES if k not in QUANTIZED))
def test_mesh_steps_match_jax(runs, case):
    """3 SGD steps on each mesh against the JAX step on the mesh of the same
    shape: every rank's metrics (loss, accuracy; grad and param norms,
    clipped at 0.5, where logged: each element counted once however the
    leaves are split) and the whole model gathered after the last step."""
    want_metrics, want_params, _ = runs["want"][case]
    for rank in _ranks_of(runs, case):
        got = rank[case]["metrics"]
        assert [sorted(g) for g in got] == [sorted(w) for w in want_metrics]
        np.testing.assert_allclose([[g[k] for k in sorted(g)] for g in got],
                                   [[w[k] for k in sorted(w)] for w in want_metrics],
                                   rtol=1e-5, atol=1e-7)
    sd = _first(runs, case)["state"]
    for name, w in lm_state_dict_from_jax(want_params).items():
        np.testing.assert_allclose(sd[name].numpy(), w.numpy(), rtol=1e-4, atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("case", QUANTIZED)
def test_mesh_int8_steps_match_jax(runs, case):
    """The int8 emulation (GSPMD twin, on the clipped gradient; under
    tensor parallelism and ``--zero wus`` on each leaf gathered whole, in
    the JAX blocks) and the explicit bucketed int8 wire at two ranks: the
    A9 two-rank tolerances, on the weights and on the residual."""
    want_metrics, want_params, want_residual = runs["want"][case]
    got = _first(runs, case)
    np.testing.assert_allclose([[g[k] for k in sorted(g)] for g in got["metrics"]],
                               [[w[k] for k in sorted(w)] for w in want_metrics], rtol=2e-3)
    for name, w in lm_state_dict_from_jax(want_params).items():
        a, b = got["state"][name].numpy(), w.numpy()
        err = np.abs(a - b)
        big = max(float(np.abs(b).max()), 1e-6)
        assert np.mean(err <= 2e-3 * big + 2.0 ** -6 * np.abs(b)) >= 0.99, name
        assert err.max() <= 5e-2 * big, name
    # The error-feedback residual of the last step (JAX layout; stacked per
    # rank on the explicit step): a block at a rounding boundary leaves one
    # quantization step, up to twice the largest residual, where the other
    # side leaves none.  A residual kept on the unclipped gradient is off on
    # most elements.
    got_residual = jax.tree_util.tree_leaves(got["residual"])
    assert len(got_residual) == len(jax.tree_util.tree_leaves(want_residual))
    for a, b in zip(got_residual, jax.tree_util.tree_leaves(want_residual)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        err = np.abs(a - b)
        big = max(float(np.abs(b).max()), 1e-9)
        assert np.mean(err <= 2e-3 * big + 2.0 ** -6 * np.abs(b)) >= 0.99
        assert err.max() <= 3.0 * big


def test_fsdp_and_zero_hold_part_of_the_bytes(runs):
    """Per rank, FSDP 2 holds about half the parameters and momentum of DP 2
    (the leaves under 1024 elements stay whole); ZeRO about half the
    momentum; TP 2 about half the parameters."""
    dp, fsdp = runs["ranks"][0]["dp2"], runs["ranks"][0]["fsdp2"]
    assert fsdp["param_bytes"] < 0.62 * dp["param_bytes"]
    assert fsdp["momentum_bytes"] < 0.62 * dp["momentum_bytes"]
    wus = runs["ranks"][2]["dp2_wus"]
    assert wus["momentum_bytes"] < 0.62 * dp["momentum_bytes"]
    assert runs["ranks"][2]["tp2"]["param_bytes"] < 0.62 * dp["param_bytes"]


def test_qkv_takes_each_ranks_head_group_in_every_third():
    """The JAX qkv kernel is ``[C, 3C]`` split ``[q | k | v]``: rank r holds
    the columns of its heads in each third (3 heads of 8 at tp 2: heads 0-1,
    then head 2), which a contiguous half of the columns is not; ``proj``
    takes the same heads' rows, ``gather_state`` puts the JAX order back."""
    kernel = np.arange(24 * 72, dtype=np.float32).reshape(24, 72)   # JAX [in, out]
    weight = torch.from_numpy(kernel.T.copy())                      # torch [out, in]
    specs = tp_lib.tp_specs(lm_shapes(64, 24, 1), 3, 2)
    split = specs["blocks.0.attn.qkv.weight"]
    heads = [(0, 16), (16, 24)]
    for r, (lo, hi) in enumerate(heads):
        cols = [t * 24 + c for t in range(3) for c in range(lo, hi)]
        np.testing.assert_array_equal(tp_lib.shard_tensor(weight, split, r).numpy(),
                                      kernel[:, cols].T)
        assert cols != list(range(36 * r, 36 * (r + 1)))
        assert specs["blocks.0.attn.proj.weight"].of(r) == tuple(range(lo, hi))
    assert tp_lib.gather_tensor(weight, split, None) is weight


def test_uneven_splits_run_where_jax_runs_and_refuse_in_its_words():
    """Heads, the MLP and the vocab split into near-equal contiguous parts;
    where GSPMD cannot place a leaf (vocab 63 at tp 2) the port refuses
    with the JAX device placement's message, and a head count tp does not
    divide runs (the ``tp2`` cases train 3 heads at tp 2 against JAX)."""
    assert tp_lib.split_sizes(3, 2) == [2, 1] and tp_lib.split_range(7, 3, 2) == (5, 7)
    tp_lib.check_tp(lm_shapes(64, 24, 1), 1, 2)   # 3 heads at tp 2: runs
    mesh = build_mesh(MeshSpec(("data", "model"), (1, 2)), jax.devices()[:2])
    with pytest.raises(ValueError) as want:
        jax.device_put(np.zeros((63, 24), np.float32), NamedSharding(mesh, P("model", None)))
    with pytest.raises(ValueError) as got:
        tp_lib.check_tp(lm_shapes(63, 24, 1), 1, 2)
    assert str(got.value) == str(want.value)
    with pytest.raises(SystemExit, match="not divisible by tp"):
        lm_pretrain.run(RECIPE + ["--tp", "3"])
    dims = fsdp_dims(lm_shapes(64, 24, 1), tp_lib.tp_specs(lm_shapes(64, 24, 1), 3, 2), 2)
    jdims = fsdp_specs(jax.eval_shape(lambda: JaxLM(**{**CFG, "n_layers": 1}).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)))["params"], mesh=_FakeMesh(),
        base_specs=tp_specs(jax.eval_shape(lambda: JaxLM(**{**CFG, "n_layers": 1}).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)))["params"]))
    assert dims["embed.weight"] == 1 and jdims["embed"]["embedding"] == P("model", "data")
    assert dims["blocks.0.fc1.weight"] == 1
    assert jdims["block_0"]["fc1"]["kernel"] == P("data", "model")
    assert dims["blocks.0.ln1.weight"] is None


class _FakeMesh:
    shape = {"data": 2, "model": 2}


def test_checkpoints_cross_meshes_both_ways(runs):
    """A JAX-written file loads into TP 2 and into FSDP 2 (each gathered back
    to the file's trees bit for bit); TP 2's own file, written by its rank 0
    in the whole model's JAX layout, loads in the JAX package and into DP 2
    and FSDP 2, bit for bit."""
    jstate = runs["jstate"]
    for holder in (runs["ranks"][0], runs["ranks"][2]):
        trees = holder["from_jax"]
        for a, b in zip(jax.tree_util.tree_leaves(trees["params"]),
                        jax.tree_util.tree_leaves(jstate.params)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(jax.tree_util.tree_leaves(trees["momentum"]),
                        jax.tree_util.tree_leaves(jstate.momentum)):
            np.testing.assert_array_equal(a, b)
    saved = runs["ranks"][2]["tp_saved"]
    path = str(runs["out"] / "ck_tp" / "checkpoint.msgpack")
    template = TrainState.create({"params": runs["params"]}, sgd_init(runs["params"]))
    loaded, meta = jax_ckpt.load_checkpoint(path, template)
    assert meta["ft"]["step"] == 7
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(loaded.params)),
                    jax.tree_util.tree_leaves(saved["params"])):
        np.testing.assert_array_equal(a, b)
    for name in ("to_dp", "to_fsdp"):
        trees = runs["ranks"][0][name]
        for key in ("params", "momentum"):
            for a, b in zip(jax.tree_util.tree_leaves(trees[key]),
                            jax.tree_util.tree_leaves(saved[key])):
                np.testing.assert_array_equal(a, b)
    assert sorted(os.listdir(runs["out"] / "ck_tp")) == [
        "checkpoint.msgpack", "checkpoint.msgpack.sha256"]


def test_tp_generate_emits_jax_tokens(runs):
    """Greedy decode with 2 + 1 heads over two ranks, dense prefill, against
    the JAX ``tp_generate`` on a 2-device model mesh: identical tokens."""
    assert runs["ranks"][2]["tokens"] == np.asarray(runs["tokens"]).tolist()


def test_recipes_across_ranks(runs):
    """``lm_pretrain --tp 2`` and ``lm_generate --tp 2`` through their own
    bootstrap at two gloo ranks: the ``(1, 2)`` mesh, the world-1 recipe's
    losses (3-LM-step row), rank 0 alone writing the checkpoint; the same
    tokens as ``lm_generate`` at world 1, printed by rank 0 only."""
    for r in (0, 1):
        rec = runs["ranks"][r]["recipe"]
        assert rec["backend"] == "gloo" and rec["mesh"] == {"data": 1, "model": 2}
        np.testing.assert_allclose(rec["losses"], runs["world1"], rtol=1e-5)
    assert sorted(os.listdir(runs["out"] / "rck"))[0] == "checkpoint.msgpack"
    assert runs["ranks"][0]["gen_out"].splitlines()[-1] == runs["gen1"].splitlines()[-1]
    assert "tokens:" not in runs["ranks"][1]["gen_out"]
