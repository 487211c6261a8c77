"""The gradient-communication stack of the port (``ops/qcomm.py``,
``parallel/zero.py``, ``parallel/overlap.py``, ``train/gradsync.py``)
against the JAX package, in one process.  Multi-rank cases ride the 2-rank
worker of ``tests/test_torch_dist_train.py``.

Tolerances (PERF.md §2):

- the quantizers, ``chunk_layout``, ``fake_quantize`` and the emulation
  with its residual carried three rounds, ``plan_buckets``, and the
  payloads, scales and results of the one-rank compressed all-reduce,
  reduce-scatter and all-gather against JAX's on a one-device mesh: bitwise
  (the same f32 operations in the same order as XLA compiles them;
  numpy-seeded inputs with all-zero blocks, ragged leaves and a leaf of
  1e-20 magnitudes); subnormal values compare as zero (XLA's CPU code
  flushes them, PyTorch keeps them).  The collectives' residuals: within
  the rounding of one dequantized product (2**-22 of the values around
  them), because XLA fuses that product into the subtraction for some
  residuals and not for others, and the port rounds the exact error once;
- ``gather_momentum`` / ``shard_momentum``: exact;
- three ``lm_pretrain`` steps per new flag against the JAX ``LMTrainer`` on
  a one-device mesh, f32: PERF.md's 3-LM-step row (losses rtol 1e-5,
  weights atol 2e-5, rtol 1e-4); under int8/fp8, 99% of each leaf's
  elements there and all within one quantum's update carried by momentum
  (an element at a rounding boundary may quantize one step apart);
- checkpoints with residuals and ZeRO momentum across the two packages,
  both ways, and across modes: exact;
- the JAX refusals, word for word.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pytorch_distributed_tpu.models import resnet as jr
from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.ops import qcomm as jq
from pytorch_distributed_tpu.parallel import MeshSpec, build_mesh
from pytorch_distributed_tpu.parallel import overlap as jo
from pytorch_distributed_tpu.parallel import zero as jz
from pytorch_distributed_tpu.recipes import lm_pretrain as jax_lm_pretrain
from pytorch_distributed_tpu.train import checkpoint as jax_ckpt
from pytorch_distributed_tpu.train import lm as jax_lm
from pytorch_distributed_tpu.train.optim import sgd_init
from pytorch_distributed_tpu.train.state import TrainState
from pytorch_distributed_tpu.train.steps import make_train_step as jax_train_step
from pytorch_distributed_tpu_torch.models import resnet as tr
from pytorch_distributed_tpu_torch.models.transformer import TransformerLM
from pytorch_distributed_tpu_torch.ops import qcomm
from pytorch_distributed_tpu_torch.parallel import overlap, zero
from pytorch_distributed_tpu_torch.recipes import lm_pretrain
from pytorch_distributed_tpu_torch.train import checkpoint as ckpt
from pytorch_distributed_tpu_torch.train import lm
from pytorch_distributed_tpu_torch.train.config import parse_config
from pytorch_distributed_tpu_torch.train.optim import sgd
from pytorch_distributed_tpu_torch.train.steps import make_train_step
from pytorch_distributed_tpu_torch.train.trainer import Trainer
from pytorch_distributed_tpu_torch.utils.convert import (
    jax_leaves,
    lm_params_to_jax,
    lm_state_dict_from_jax,
    resnet_params_to_jax,
    resnet_state_dict_from_jax,
    resnet_variables_to_jax,
)

RES = dict(stage_sizes=[1, 1], num_classes=7, num_filters=16)
LM = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh1():
    return build_mesh(MeshSpec(("data",), (1,)), jax.devices()[:1])


def _f(x) -> np.ndarray:
    """f32 numpy view of either package's array (fp8 and int8 widened)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ftz(a: np.ndarray) -> np.ndarray:
    """Subnormal f32 values read as zero: XLA's CPU code flushes them, so a
    residual JAX flushed may be a subnormal number in the port."""
    return np.where(np.abs(a) < np.finfo(np.float32).tiny, np.float32(0), a)


def _equal_trees(got, want):
    g, w = qcomm.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a, b = _ftz(_f(a)), _ftz(_f(b))
        assert a.shape == b.shape and np.array_equal(a, b)


def _residuals_close(got, want, *scales):
    """Residuals equal up to the rounding of one dequantized product
    ``q * scale`` (XLA fuses that product into the subtraction for some
    residuals and not for others; the port rounds the exact error once):
    elementwise within 2**-22 of the magnitudes in ``scales`` (the
    quantizers' inputs and outputs, leaf by leaf, broadcast to a slot)."""
    g, w = qcomm.tree_leaves(got), jax.tree_util.tree_leaves(want)
    mags = [[np.abs(_f(x)) for x in qcomm.tree_leaves(t)] for t in scales]
    for i, (a, b) in enumerate(zip(g, w)):
        a, b = _f(a), _f(b)
        bound = 2.0 ** -22 * sum(m[i].reshape(a.shape[-m[i].ndim:] if m[i].ndim else ())
                                 for m in mags) + np.finfo(np.float32).tiny
        assert a.shape == b.shape and (np.abs(a - b) <= bound).all()


def _grads(seed=0):
    """Ragged leaves, an all-zero leaf and all-zero blocks, magnitudes over
    six decades."""
    rng = np.random.default_rng(seed)
    big = (rng.normal(size=(3, 700)) * np.logspace(-3, 3, 700)).astype(np.float32)
    big[1, 256:512] = 0.0
    return {"a": big, "b": rng.normal(size=(7,)).astype(np.float32),
            "c": {"k": rng.normal(size=(3, 3, 4, 5)).astype(np.float32),
                  "z": np.zeros((300,), np.float32)},
            "d": rng.normal(size=(513,)).astype(np.float32) * 1e-20}


# ------------------------------------------------------------ quantizers

# The JAX functions run jitted, as inside the JAX steps: XLA turns the
# scale's division by qmax into a product with its reciprocal and fuses a
# residual's multiply into its subtraction; the port follows the compiled
# numbers.
_jit_qb = jax.jit(jq.quantize_blockwise, static_argnums=(1, 2))
_jit_dqb = jax.jit(jq.dequantize_blockwise, static_argnums=2)
_jit_q = jax.jit(jq._quantize, static_argnums=1)
_jit_fq = jax.jit(jq.fake_quantize, static_argnums=1)


def _boundary_blocks(mode):
    """Blocks of absmax 1 whose other elements sit within a few ulps of the
    midpoints between the payload's levels: there ``x * (qmax / absmax)``
    and ``x / scale`` round to different levels, so only the JAX rule's
    arithmetic passes on them."""
    qmax = qcomm._QMAX[mode]
    if mode == "int8":
        mids = np.arange(127, dtype=np.float64) + 0.5
    else:
        vals = torch.arange(256, dtype=torch.uint8).view(qcomm._FP8).float().abs().numpy()
        vals = np.unique(vals[np.isfinite(vals) & (vals <= qmax)])
        mids = (vals[:-1] + vals[1:]) / 2
    scale = np.float64(np.float32(1) / np.float32(qmax))
    xs = np.concatenate([mids * scale * (1 + j * 2.0 ** -23) for j in range(-4, 5)])
    xs = np.concatenate([xs, np.zeros((-len(xs)) % 255)]).reshape(-1, 255)
    return np.concatenate([np.ones((len(xs), 1)), xs], 1).astype(np.float32)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_blockwise_is_jax_bitwise(mode):
    for x in qcomm.tree_leaves(_grads()):
        for block in (256, 64):
            q, s = qcomm.quantize_blockwise(torch.from_numpy(x), mode, block)
            jq_, js = _jit_qb(jnp.asarray(x), mode, block)
            assert np.array_equal(_f(q), _f(jq_)) and np.array_equal(_f(s), _f(js))
            back = qcomm.dequantize_blockwise(q, s, x.shape)
            assert np.array_equal(_f(back), _f(_jit_dqb(jq_, js, x.shape)))
    xb = np.random.default_rng(1).normal(size=(5, 3, 16)).astype(np.float32)
    xb[2, 1] = 0.0
    q, s = qcomm._quantize(torch.from_numpy(xb), mode)
    jq_, js = _jit_q(jnp.asarray(xb), mode)
    assert np.array_equal(_f(q), _f(jq_)) and np.array_equal(_f(s), _f(js))
    assert _f(s)[2, 1] == 0.0 and not _f(q)[2, 1].any()
    xb = _boundary_blocks(mode)
    q, s = qcomm._quantize(torch.from_numpy(xb), mode)
    jq_, js = _jit_q(jnp.asarray(xb), mode)
    assert np.array_equal(_f(q), _f(jq_)) and np.array_equal(_f(s), _f(js))


def test_chunk_layout_is_jax():
    for size in (1, 2, 7, 10, 255, 256, 257, 1000, 4097, 65536, 100003):
        for n in (1, 2, 3, 4, 8):
            for block in (256, 64, 1):
                assert qcomm.chunk_layout(size, n, block) == jq.chunk_layout(size, n, block)
                assert zero.chunk_size(size, n, block) == jz.chunk_size(size, n, block)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_fake_quantize_and_emulation_carry_the_residual_bitwise(mode):
    grads = _grads(2)
    tg = qcomm.tree_unflatten(grads, [torch.from_numpy(x) for x in qcomm.tree_leaves(grads)])
    for x in qcomm.tree_leaves(grads):
        assert np.array_equal(_f(qcomm.fake_quantize(torch.from_numpy(x), mode)),
                              _f(_jit_fq(jnp.asarray(x), mode)))
    res, jres = qcomm.init_residual(tg, mode), jq.init_residual(grads, mode)
    emulated = jax.jit(jq.compress_emulated, static_argnums=2)
    for r in range(3):
        out, res = qcomm.compress_emulated(tg, res, mode)
        jout, jres = emulated(grads, jres, mode)
        _equal_trees(out, jout)
        _equal_trees(res, jres)
    assert qcomm.init_residual(tg, "bf16") == {} and qcomm.compress_emulated(tg, {}, mode)[1] == {}


def test_resolve_mode_and_fp8_are_jax():
    assert qcomm.resolve_mode(None) == ("none", None)
    assert qcomm.resolve_mode("bf16") == ("bf16", torch.bfloat16)
    assert qcomm.resolve_mode("int8") == ("int8", None) and qcomm.fp8_supported()
    for bad in ("int4", "f16"):
        with pytest.raises(ValueError) as a:
            qcomm.resolve_mode(bad)
        with pytest.raises(ValueError) as b:
            jq.resolve_mode(bad)
        assert str(a.value) == str(b.value)
    with pytest.raises(ValueError, match="conflicts with"):
        qcomm.resolve_mode("int8", torch.bfloat16)


# ------------------------------------------------------ buckets, layouts

def _resnet(**kw):
    return tr.ResNet(block_cls=tr.Bottleneck, **{**RES, "device": "cpu", **kw})


@pytest.mark.parametrize("bucket_mb", [1e-4, 0.003, 0.05, 4.0])
def test_plan_buckets_are_jax_on_both_models(bucket_mb):
    """The port plans over its parameters in the JAX leaf order; JAX over
    its params tree: the same index lists."""
    for model, to_jax in ((_resnet(), resnet_params_to_jax),
                          (TransformerLM(**LM, device="cpu"), lm_params_to_jax)):
        tree = to_jax(model.state_dict())
        named = dict(model.named_parameters())
        leaves = [named[leaf.name] for leaf in jax_leaves(model)]
        assert overlap.plan_buckets(leaves, bucket_mb) == jo.plan_buckets(tree, bucket_mb)
        assert len(overlap.plan_buckets(leaves, bucket_mb)) == jo.n_buckets(tree, bucket_mb)
    with pytest.raises(ValueError, match="bucket_mb must be > 0"):
        overlap.plan_buckets([torch.zeros(3)], 0.0)


@pytest.mark.parametrize("bucket_mb", [1e-4, 0.003, 0.05])
def test_train_step_buckets_are_the_jax_plan(bucket_mb):
    """The buckets the train step syncs hold the JAX package's leaves: its
    ``plan_buckets`` over the JAX params tree, mapped to the port's names."""
    from pytorch_distributed_tpu_torch.train.gradsync import GradSync

    for model, to_jax in ((_resnet(), resnet_params_to_jax),
                          (TransformerLM(**LM, device="cpu"), lm_params_to_jax)):
        want = jo.plan_buckets(to_jax(model.state_dict()), bucket_mb)
        order = [leaf.name for leaf in jax_leaves(model)]
        comm = GradSync(model, None, mode="int8", cast_dtype=None, explicit=True,
                        overlap="bucketed", bucket_mb=bucket_mb)
        got = [[order.index(comm.leaves[i].name) for i in b.index] for b in comm.buckets]
        assert got == want


def test_momentum_gather_shard_round_trip_is_exact_and_jax():
    """``shard_momentum`` / ``gather_momentum`` (what ``GradSync`` restores
    and checkpoints ZeRO momentum through) against JAX's on its stacked
    templates, and the round trip exact."""
    rng = np.random.default_rng(7)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in (("a", (3, 700)), ("b", (7,)), ("c", (300,)))}
    for n in (1, 2, 4):
        jmom = jz.init_wus_momentum(params, n, quantized=True)
        full = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        chunks = zero.shard_momentum(full, jmom["buf"])
        _equal_trees(chunks, jz.shard_momentum(full, jmom["buf"]))
        back = zero.gather_momentum({"buf": chunks}, params)
        _equal_trees(back, full)
        _equal_trees(back, jz.gather_momentum({"buf": chunks, "agerr": jmom["agerr"]}, params))


# ------------------------------------------- one-rank collectives vs JAX

@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_one_rank_compressed_collectives_are_jax_bitwise(mesh1, mode):
    """The port with no group against the JAX functions inside
    ``shard_map`` on a one-device mesh: the all-reduce (twice quantized,
    the stage-2 error folded into the residual), the reduce-scatter and
    the all-gather with error feedback, three rounds each."""
    grads = _grads(3)
    tg = qcomm.tree_unflatten(grads, [torch.from_numpy(x) for x in qcomm.tree_leaves(grads)])

    def psum(g, r):
        return jq.compressed_psum(g, r, "data", mode=mode)

    def rs(g, r):
        return jq.compressed_reduce_scatter(g, r, "data", mode=mode)

    def ag(c, e):
        return jq.compressed_all_gather(c, e, "data", grads, mode=mode)

    specs = (P(), P("data"))
    jpsum, jrs, jag = (jax.jit(jax.shard_map(f, mesh=mesh1, in_specs=specs,
                                             out_specs=(P(), P("data")), check_vma=False))
                       for f in (psum, rs, ag))
    # Each round starts both sides from JAX's residual of the last, so every
    # round holds the functions on the same inputs.
    jres = jr2 = jq.init_residual(grads, mode, True, 1)
    for _ in range(3):
        res = qcomm.tree_unflatten(jres, [torch.from_numpy(np.array(x))
                                          for x in jax.tree_util.tree_leaves(jres)])
        out, res = qcomm.compressed_psum(tg, res, None, mode)
        jin = jres
        jout, jres = jpsum(grads, jres)
        _equal_trees(out, jout)
        _residuals_close(res, jres, grads, jin, jout)
        r2 = qcomm.tree_unflatten(jr2, [torch.from_numpy(np.array(x))
                                        for x in jax.tree_util.tree_leaves(jr2)])
        chunks, r2 = qcomm.compressed_reduce_scatter(tg, r2, None, mode)
        jin = jr2
        jchunks, jr2 = jrs(grads, jr2)
        _equal_trees(chunks, jchunks)
        _residuals_close(r2, jr2, grads, jin)
    jerr = jax.tree_util.tree_map(lambda c: jnp.zeros((1,) + c.shape), jchunks)
    chunks = qcomm.tree_unflatten(grads, [torch.from_numpy(np.array(c))
                                          for c in jax.tree_util.tree_leaves(jchunks)])
    for _ in range(3):
        err = qcomm.tree_unflatten(jerr, [torch.from_numpy(np.array(x))
                                          for x in jax.tree_util.tree_leaves(jerr)])
        full, err = qcomm.compressed_all_gather(chunks, err, None, tg, mode)
        jin = jerr
        jfull, jerr = jag(jchunks, jerr)
        _equal_trees(full, jfull)
        _residuals_close(err, jerr, jchunks, jin)
    with pytest.raises(ValueError, match="compressed_psum: mode must be one of"):
        qcomm.compressed_psum(tg, {}, None, "bf16")


@pytest.mark.parametrize("mode,cast", [("none", None), ("bf16", "bf16"), ("int8", None)])
def test_one_rank_zero_and_overlap_functions_match_jax(mesh1, mode, cast):
    """``parallel/zero.py`` and ``parallel/overlap.py`` with no group against
    their JAX twins inside ``shard_map`` on a one-device mesh: the
    reduce-scatter, the bucketed all-reduce and reduce-scatter, the whole
    ZeRO update with its gather, and the deferred gather's drain and its
    host twin (JAX's ``materialize_params``, against the port's drain).
    Bitwise, except the SGD arithmetic of the ZeRO update
    (torch's ``add(alpha=)`` against XLA's products and sums: 2**-22
    relative) and the residuals (``_residuals_close``)."""
    grads = _grads(4)
    params = jax.tree_util.tree_map(lambda v: v * 3 + 1, _grads(5))
    tg, tp = (qcomm.tree_unflatten(t, [torch.from_numpy(np.array(x))
                                       for x in qcomm.tree_leaves(t)]) for t in (grads, params))
    jcast, tcast = (jnp.bfloat16, torch.bfloat16) if cast else (None, None)
    mb = 0.001

    def body(g, p, r, buf, err):
        rs = jz.reduce_scatter_grads(g, "data", 1, cast_dtype=jcast)
        ps, pr = jo.bucketed_psum(g, r, "data", mode=mode, cast_dtype=jcast, bucket_mb=mb)
        bs, br = jo.bucketed_reduce_scatter(g, r, "data", 1, mode=mode, cast_dtype=jcast,
                                            bucket_mb=mb)
        mom = {"buf": buf, **({"agerr": err} if mode == "int8" else {})}
        newp, newm = jz.wus_apply_updates(p, mom, bs, jnp.float32(0.1), 0, 1, "data",
                                          mode=mode, cast_dtype=jcast, bucket_mb=mb)
        drained = jo.drain_pending(p, buf, "data", cast_dtype=jcast)
        return rs, ps, pr, bs, br, newp, newm, drained

    jres = jq.init_residual(grads, mode, True, 1)
    jbuf = jax.tree_util.tree_map(lambda x: jnp.asarray(np.random.default_rng(6).normal(
        size=(1, jz.chunk_size(x.size, 1))).astype(np.float32)), grads)
    jerr = jax.tree_util.tree_map(lambda b: b * 1e-3, jbuf)
    f = jax.jit(jax.shard_map(body, mesh=mesh1, in_specs=(P(), P(), P("data"), P("data"),
                                                          P("data")),
                              out_specs=P(), check_vma=False))
    want = jax.device_get(f(grads, params, jres, jbuf, jerr))
    t = lambda tree: qcomm.tree_unflatten(tree, [torch.from_numpy(np.array(x))  # noqa: E731
                                                 for x in jax.tree_util.tree_leaves(tree)])
    tres, tbuf, terr = t(jres), t(jbuf), t(jerr)
    rs = zero.reduce_scatter_grads(tg, None, 1, cast_dtype=tcast)
    ps, pr = overlap.bucketed_psum(tg, tres, None, mode=mode, cast_dtype=tcast, bucket_mb=mb)
    bs, br = overlap.bucketed_reduce_scatter(tg, tres, None, 1, mode=mode, cast_dtype=tcast,
                                             bucket_mb=mb)
    mom = {"buf": tbuf, **({"agerr": terr} if mode == "int8" else {})}
    newp, newm = zero.wus_apply_updates(tp, mom, bs, 0.1, 0, 1, None, mode=mode,
                                        cast_dtype=tcast, bucket_mb=mb)
    drained = overlap.drain_pending(tp, tbuf, None, cast_dtype=tcast)
    for got, w in ((rs, want[0]), (ps, want[1]), (bs, want[3]), (drained, want[7])):
        _equal_trees(got, w)
    if mode == "int8":
        _residuals_close(pr, want[2], grads)
        _residuals_close(br, want[4], grads)
    # One rounding apart in each operation: within 2**-21 of the operands'
    # magnitudes (the old values and the results; the gradient for the
    # buffer).
    for got, w, around in ((newp, want[5], [params]), (newm["buf"], want[6]["buf"],
                                                       [jbuf, want[3]])):
        for i, (a, b) in enumerate(zip(qcomm.tree_leaves(got), jax.tree_util.tree_leaves(w))):
            a, b = _f(a), _f(b)
            mags = np.abs(b) + sum(np.abs(_f(jax.tree_util.tree_leaves(t)[i])).reshape(
                b.shape if np.size(jax.tree_util.tree_leaves(t)[i]) == b.size else (-1,))
                for t in around)
            assert (np.abs(a - b) <= 2.0 ** -21 * mags).all()
    _equal_trees(drained, jo.materialize_params(params, jbuf, cast_dtype=jcast))
    assert float(zero.chunk_sq_sum(bs)) == pytest.approx(
        float(jz.chunk_sq_sum(jax.tree_util.tree_map(jnp.asarray, want[3]))), rel=1e-6)


def test_packed_layout_keeps_every_leafs_blocks():
    """Leaves of other block sizes packed together quantize as each alone."""
    sizes, n = [700, 7, 300, 5000, 1], 3
    lay = qcomm.PackedLayout(sizes, n)
    rng = np.random.default_rng(5)
    leaves = [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in sizes]
    x = lay.pack(leaves)
    q, s = lay.quantize(x, "int8")
    deq = lay.dequantize(q, s)
    for i, t in enumerate(leaves):
        total, nb = qcomm.chunk_layout(sizes[i], n)
        alone = torch.nn.functional.pad(t, (0, total - sizes[i])).view(-1, total // n // nb)
        want = qcomm._dequantize(*qcomm._quantize(alone, "int8")).reshape(-1)[:sizes[i]]
        assert torch.equal(lay.unpack(deq, [(s_,) for s_ in sizes])[i], want)
    perm, inv, _ = lay.perms("cpu")
    assert torch.equal(perm[inv], torch.arange(lay.numel))


# ------------------------------------------------ LM recipe vs LMTrainer

TINY = ["--device", "cpu", "--vocab", "64", "--d-model", "32", "--n-heads", "4",
        "--n-layers", "2", "--seq-len", "16", "-b", "8", "--steps", "3", "-p", "1",
        "--no-eval", "--precision", "fp32", "--lr", "0.05", "--seed", "0"]


def _jax_lm(mesh1, **kw):
    ds = jax_lm.SyntheticTokenDataset(4096, 16, 64, seed=0)
    trainer = jax_lm.LMTrainer(JaxLM(**LM, dtype=jnp.float32), mesh1, ds, 8, lr=0.05,
                               prefetch=0, **kw)
    init = jax.device_get(trainer.state.params)
    losses, step_fn = [], trainer.step_fn

    def recording(state, tokens, lr):
        state, m = step_fn(state, tokens, lr)
        losses.append(float(m["loss"]))
        return state, m

    trainer.step_fn = recording
    trainer.fit(3, print_freq=100)
    return init, losses, trainer.state


@pytest.mark.parametrize("flags,kw", [
    (["--grad-compress", "int8"], dict(grad_compress="int8")),
    (["--zero", "wus"], dict(zero="wus")),
    (["--overlap", "bucketed", "--bucket-mb", "0.01"], dict(overlap="bucketed", bucket_mb=0.01)),
    (["--overlap", "bucketed", "--bucket-mb", "0.01", "--grad-compress", "fp8"],
     dict(overlap="bucketed", bucket_mb=0.01, grad_compress="fp8")),
], ids=["int8_emulation", "zero_wus", "bucketed", "bucketed_fp8"])
def test_lm_pretrain_flags_match_jax_lm_trainer(mesh1, monkeypatch, flags, kw):
    init, want_losses, want = _jax_lm(mesh1, **kw)
    monkeypatch.setattr(TransformerLM, "init_weights",
                        lambda self, gen: self.load_state_dict(lm_state_dict_from_jax(init)))
    trainer = lm_pretrain.run(TINY + flags)
    np.testing.assert_allclose([float(x) for x in trainer.losses], want_losses, rtol=1e-5)
    got = lm_params_to_jax(trainer.model.state_dict())
    jres = jax.tree_util.tree_leaves(jax.device_get(want.residual))
    for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(got),
                                   jax.tree_util.tree_leaves(jax.device_get(want.params)))):
        close = np.abs(a - b) <= 2e-5 + 1e-4 * np.abs(b)
        if not jres:
            assert close.all()
            continue
        # Quantized: the two sides' gradients differ by summation order, so
        # an element at a rounding boundary may quantize one step apart (a
        # quantum is at most twice the largest residual), an update of lr
        # times that, carried by momentum 0.9 over three steps.
        assert close.mean() >= 0.99
        flip = 2e-5 + (1 + 0.9 + 0.81) * 0.05 * 2 * np.abs(jres[i]).max()
        assert (np.abs(a - b) <= flip).all()
    if jres:   # the residual is live and in JAX's layout
        res = jax.tree_util.tree_leaves(trainer.comm.checkpoint_trees()["residual"])
        assert [np.shape(x) for x in res] == [np.shape(x) for x in jres]
        assert sum(np.abs(x).sum() for x in res) > 0


# ---------------------------------------------------------------- refusals

def _message(fn):
    with pytest.raises((ValueError, SystemExit)) as exc:
        fn()
    return str(exc.value)


@pytest.mark.parametrize("kw", [
    dict(overlap="bucketed"),
    dict(explicit_collectives=True, wus_gather="lazy"),
    dict(explicit_collectives=True, wus_gather="deferred", zero="wus"),
    dict(explicit_collectives=True, wus_gather="deferred", overlap="bucketed"),
    dict(explicit_collectives=True, wus_gather="deferred", overlap="bucketed", zero="wus",
         grad_compress="int8"),
    dict(grad_compress="int4"), dict(zero="zero3"), dict(overlap="eager"),
])
def test_train_step_refusals_are_jax_word_for_word(mesh1, kw):
    jm = jr.ResNet(block_cls=jr.Bottleneck, **RES)
    model = _resnet()
    assert _message(lambda: make_train_step(model, sgd(model.parameters()), **kw)) == \
        _message(lambda: jax_train_step(jm, mesh1, **kw))


@pytest.mark.parametrize("kw", [dict(accum_steps=2), dict(fused_ce_chunks=2),
                                dict(zero="wus"), dict(accum_steps=2, zero="wus")])
def test_lm_explicit_step_refusals_are_jax_word_for_word(mesh1, kw):
    model = TransformerLM(**LM, device="cpu")
    jm = JaxLM(**LM)
    params = jax.tree_util.tree_map(np.asarray, lm_params_to_jax(model.state_dict()))
    from pytorch_distributed_tpu.parallel.tp import replicated_like

    assert _message(lambda: lm.make_lm_train_step(model, sgd(model.parameters()),
                                                  overlap="bucketed", **kw)) == \
        _message(lambda: jax_lm.make_lm_train_step(jm, mesh1, replicated_like(params),
                                                   overlap="bucketed", params=params, **kw))


@pytest.mark.parametrize("flags", [["--zero", "wus"], ["--accum-steps", "2"],
                                   ["--fused-ce", "2"], ["--fsdp"]])
def test_lm_pretrain_bucketed_refusal_is_jax_word_for_word(flags):
    argv = ["--overlap", "bucketed", "--steps", "2"] + flags
    assert _message(lambda: lm_pretrain.main(TINY[:1] + ["cpu"] + argv)) == \
        _message(lambda: jax_lm_pretrain.main(argv))


# ------------------------------------------------- checkpoints, both ways

def _res_variables(seed=0):
    jm = jr.ResNet(block_cls=jr.Bottleneck, **RES)
    v = jax.jit(jm.init, static_argnames="train")(jax.random.PRNGKey(seed),
                                                    jnp.zeros((1, 8, 8, 3)), train=False)
    return jax.tree_util.tree_map(np.asarray, v)


def _port(variables, **kw):
    model = _resnet()
    model.load_state_dict(resnet_state_dict_from_jax(variables["params"],
                                                     variables["batch_stats"]))
    opt = sgd(model.parameters())
    return model, opt, make_train_step(model, opt, **kw)


def _run(step, n=2, seed=4):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        step({"images": torch.from_numpy(rng.normal(size=(8, 8, 8, 3)).astype(np.float32)),
              "labels": torch.from_numpy(rng.integers(0, 7, size=8)),
              "weights": torch.ones(8)}, 0.1)


def _save(tmp, model, opt, step):
    return ckpt.save_checkpoint(str(tmp), model, opt, 5, 1, "resnet", 0.0, False,
                                **step.comm.checkpoint_trees())


def _template(variables, momentum, residual):
    return TrainState(step=jnp.zeros((), jnp.int32),
                      params=jax.tree_util.tree_map(np.zeros_like, variables["params"]),
                      batch_stats=jax.tree_util.tree_map(np.zeros_like,
                                                         variables["batch_stats"]),
                      momentum=momentum, residual=residual)


@pytest.mark.parametrize("case", ["explicit_int8", "gspmd_fp8", "wus_int8"])
def test_port_files_load_in_jax_and_back(tmp_path, case):
    """The port trains two steps and saves; JAX's ``load_checkpoint`` reads
    the residual (stacked or param-shaped) and the momentum exactly; a
    fresh port step restores them exactly."""
    variables = _res_variables()
    kw = {"explicit_int8": dict(explicit_collectives=True, grad_compress="int8"),
          "gspmd_fp8": dict(grad_compress="fp8"),
          "wus_int8": dict(explicit_collectives=True, grad_compress="int8", zero="wus")}[case]
    model, opt, step = _port(variables, **kw)
    _run(step)
    path = _save(tmp_path, model, opt, step)
    trees = step.comm.checkpoint_trees()
    mode = kw["grad_compress"]
    explicit = kw.get("explicit_collectives", False)
    jres = jq.init_residual(variables["params"], mode, explicit=explicit, n_data=1)
    jmom = (jz.init_wus_momentum(variables["params"], 1, quantized=True)
            if case == "wus_int8" else sgd_init(variables["params"]))
    state, meta = jax_ckpt.load_checkpoint(path, _template(variables, jmom, jres))
    assert int(state.step) == 5 and meta["ft"]["step"] == 0
    _equal_trees(trees["residual"], state.residual)
    assert sum(np.abs(x).sum() for x in jax.tree_util.tree_leaves(state.residual)) > 0
    want_mom = (jz.gather_momentum(state.momentum, state.params) if case == "wus_int8"
                else state.momentum)
    got_mom = trees["momentum"] if case == "wus_int8" else ckpt.state_trees(model, opt)["momentum"]
    _equal_trees(got_mom, want_mom)
    if case == "wus_int8":
        assert not any(np.abs(x).sum() for x in
                       jax.tree_util.tree_leaves(state.momentum["agerr"]))
    _equal_trees(resnet_variables_to_jax(model.state_dict())["params"], state.params)
    # ... and back into a fresh port step of the same mode.
    model2, opt2, step2 = _port(_res_variables(1), **kw)
    _, meta2 = ckpt.load_checkpoint(path, model2, opt2, comm=step2.comm)
    assert meta2["has_residual"]
    back = step2.comm.checkpoint_trees()
    _equal_trees(back["residual"], trees["residual"])
    if case == "wus_int8":
        _equal_trees(back["momentum"], trees["momentum"])


def test_jax_files_load_in_the_port_across_modes(tmp_path):
    """JAX writes an explicit int8 file (stacked residual) and a ZeRO file
    (param-shaped momentum); the port loads each into its own mode and into
    the other modes: the residual where its shapes fit, zeros otherwise, the
    momentum re-chunked or replicated, ``has_residual`` as the file says."""
    variables = _res_variables()
    rng = np.random.default_rng(11)
    rand = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: rng.normal(size=np.shape(x)).astype(np.float32), t)
    residual = rand(jq.init_residual(variables["params"], "int8", explicit=True, n_data=1))
    momentum = rand(variables["params"])
    state = TrainState(step=jnp.asarray(3, jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"], momentum=momentum,
                       residual=residual)
    jax_ckpt.save_checkpoint(str(tmp_path / "q"), state, 0, "resnet", 0.0, False)
    wus_state = state.replace(momentum=jz.shard_momentum(
        momentum, jz.init_wus_momentum(variables["params"], 1)["buf"]), residual={})
    wus_state = wus_state.replace(momentum={"buf": wus_state.momentum})
    jax_ckpt.save_checkpoint(str(tmp_path / "z"), wus_state, 0, "resnet", 0.0, False)
    qfile = str(tmp_path / "q" / ckpt.CHECKPOINT_NAME)
    zfile = str(tmp_path / "z" / ckpt.CHECKPOINT_NAME)
    for path, has in ((qfile, True), (zfile, False)):
        for kw in (dict(explicit_collectives=True, grad_compress="int8"),
                   dict(explicit_collectives=True, grad_compress="int8", zero="wus"),
                   dict(grad_compress="int8"), dict(zero="wus"), {}):
            model, opt, step = _port(_res_variables(2), **kw)
            _, meta = ckpt.load_checkpoint(path, model, opt, comm=step.comm)
            assert meta["has_residual"] is has
            _equal_trees(resnet_variables_to_jax(model.state_dict())["params"],
                         variables["params"])
            trees = step.comm.checkpoint_trees() if step.comm is not None else {}
            mom = trees.get("momentum") or ckpt.state_trees(model, opt)["momentum"]
            _equal_trees(mom, momentum)
            if step.comm is not None and step.comm.quantized:
                res = trees["residual"]
                fits = has and kw.get("explicit_collectives", False)
                _equal_trees(res, residual if fits else
                             jax.tree_util.tree_map(np.zeros_like, res))


def test_int8_resume_matches_the_uninterrupted_run(tmp_path, monkeypatch):
    """The explicit step at ``--grad-compress int8`` (``horovod_distributed``
    without a launcher: one rank's local collectives), a 4-step epoch
    stopped by the trainer's own API after step 2 (where ``--save-steps 2``
    saved) and resumed, ends as the run never stopped: the residual rides
    in the file.  The trainer builds the tiny Bottleneck ResNet in place of
    resnet18, to keep the test to seconds."""
    from pytorch_distributed_tpu_torch.train import trainer as trainer_mod

    monkeypatch.setattr(trainer_mod.models, "create_model",
                        lambda arch, num_classes, dtype, device, **kw: _resnet(
                            num_classes=num_classes, dtype=dtype, device=device))
    args = ["--device", "cpu", "-a", "resnet18", "--synthetic", "--image-size", "16", "-b", "4",
            "--synthetic-length", "16", "--epochs", "1", "-p", "2", "-j", "2",
            "--num-classes", "7", "--seed", "1", "--precision", "fp32", "--grad-compress",
            "int8"]

    def trainer(*extra):
        return Trainer(parse_config(args + list(extra)), explicit_collectives=True)

    ref = trainer("--checkpoint-dir", str(tmp_path / "ref"))
    ref.fit()
    d = str(tmp_path / "run")
    first = trainer("--checkpoint-dir", d, "--save-steps", "2")
    assert first.comm.quantized and first.comm.explicit
    assert first.train_epoch(0, stop_after=2) == 2
    resumed = trainer("--checkpoint-dir", d, "--resume", os.path.join(d, ckpt.CHECKPOINT_NAME))
    resumed.fit()
    want = [float(x) for x in ref.losses]
    assert [float(x) for x in first.losses + resumed.losses] == want
    for (name, a), b in zip(resumed.model.state_dict().items(),
                            ref.model.state_dict().values()):
        assert torch.equal(a, b), name
    for a, b in zip(qcomm.tree_leaves(resumed.comm.checkpoint_trees()["residual"]),
                    qcomm.tree_leaves(ref.comm.checkpoint_trees()["residual"])):
        assert np.array_equal(a, b)
