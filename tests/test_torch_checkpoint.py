"""Port's checkpoints against the JAX package's: one format, both directions.

- The msgpack codec (``utils/flax_msgpack.py``) writes flax's bytes for the
  same tree and reads flax's files, chunked arrays included (with
  ``MAX_CHUNK_SIZE`` patched small on either side).
- The inverse converters give what the JAX bridge's ``import_*_state_dict``
  gives, and round trips are exact.
- Checkpoints cross: a JAX ``save_checkpoint`` loads in the port, the port's
  file loads in JAX ``load_checkpoint``, every array and the meta exactly
  equal; the port re-saving a JAX checkpoint writes the JAX file's bytes.
- The integrity behaviours of ``tests/test_ft.py`` at the port's API.
- Resume: LM ``--save-steps`` + ``--resume`` and an image mid-epoch resume
  end where uninterrupted runs end, to ``tests/test_ft.py``'s tolerance
  (loss rel 1e-6, weights rtol 1e-6 / atol 1e-7; on the CPU they are equal).
- ``lm_generate --resume`` on a JAX-written file gives JAX's greedy tokens,
  ``serve_lm --checkpoint`` serves it, ``--pretrained`` and the orbax
  refusal.
"""

import io
import os
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from pytorch_distributed_tpu.ft import integrity as jax_integrity
from pytorch_distributed_tpu.ft.chaos import corrupt_file
from pytorch_distributed_tpu.models import resnet as jr
from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.recipes import lm_generate as jax_lm_generate
from pytorch_distributed_tpu.train import checkpoint as jax_ckpt
from pytorch_distributed_tpu.train.state import TrainState
from pytorch_distributed_tpu.utils.torch_import import (
    import_lm_state_dict,
    import_resnet_state_dict,
)
from pytorch_distributed_tpu_torch.data import DataLoader, SyntheticImageDataset
from pytorch_distributed_tpu_torch.ft import integrity
from pytorch_distributed_tpu_torch.models import resnet as tr
from pytorch_distributed_tpu_torch.models.transformer import TransformerLM
from pytorch_distributed_tpu_torch.recipes import lm_generate, lm_pretrain
from pytorch_distributed_tpu_torch.serving import serve_lm
from pytorch_distributed_tpu_torch.train import checkpoint as ckpt
from pytorch_distributed_tpu_torch.train.config import parse_config
from pytorch_distributed_tpu_torch.train.optim import sgd
from pytorch_distributed_tpu_torch.train.trainer import Trainer
from pytorch_distributed_tpu_torch.utils import flax_msgpack
from pytorch_distributed_tpu_torch.utils.convert import (
    lm_params_to_jax,
    lm_state_dict_from_jax,
    momentum_state_dict,
    resnet_params_to_jax,
    resnet_state_dict_from_jax,
    resnet_variables_to_jax,
)
from tests.test_torch_zoo import jitted_flax_init  # noqa: F401  (fixture)

LM = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=1)
# The JAX recipes' own init is replaced by the weights under test, so it may
# be compiled as one program.
pytestmark = pytest.mark.usefixtures("jitted_flax_init")
RES = dict(stage_sizes=[1, 1], num_classes=7, num_filters=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny ops only: under the parallel suite, intra-op threads contend for
    the cores, so this module runs torch on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _assert_trees_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


def _random_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: rng.normal(size=np.shape(x)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def lm_params():
    p = jax.jit(JaxLM(**LM).init)(jax.random.PRNGKey(5), jnp.zeros((1, 8), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, p["params"])


def _jax_resnet_variables(block, stem="conv7"):
    m = jr.ResNet(block_cls=getattr(jr, block), stem=stem, **RES)
    v = jax.jit(m.init, static_argnames="train")(jax.random.PRNGKey(7),
                                                 jnp.zeros((1, 8, 8, 3)), train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    # Non-trivial running statistics, so a swap of mean and var would show.
    return {"params": v["params"], "batch_stats": _random_like(v["batch_stats"], 3)}


@pytest.fixture(scope="module")
def res_variables():
    return _jax_resnet_variables("Bottleneck")


# ------------------------------------------------------------------- codec

def _codec_tree(case):
    rng = np.random.default_rng(0)
    arrays = {
        "f32": rng.normal(size=(3, 5)).astype(np.float32),
        "int32": rng.integers(-9, 9, size=(4,)).astype(np.int32),
        "zero_d": np.asarray(7, np.int32),
        "empty_dict": {},
        "bf16": np.asarray(jnp.asarray(rng.normal(size=(2, 3)), jnp.bfloat16)),
    }
    tree = {"epoch": 3, "arch": "resnet50" * 5, "best_acc1": 71.25, "neg": -300,
            "big": 2 ** 40, "flag": True, "none": None, "scalar": np.float32(2.5),
            "ft": {"step": 2, "lr_scale": 0.5},
            "state": {"leaf": arrays[case], "wide": {str(i): i for i in range(20)}}}
    port = dict(tree, state=dict(tree["state"]))
    if case == "bf16":   # the port's bf16 leaves are torch tensors
        port["state"]["leaf"] = torch.from_numpy(arrays["bf16"].view(np.int16).copy()).view(
            torch.bfloat16)
    return tree, port


@pytest.mark.parametrize("case", ["f32", "int32", "zero_d", "empty_dict", "bf16"])
def test_codec_matches_flax_both_ways(case):
    tree, port = _codec_tree(case)
    want = serialization.to_bytes(tree)
    assert flax_msgpack.to_bytes(port) == want
    back = flax_msgpack.msgpack_restore(want)
    ref = serialization.msgpack_restore(want)
    leaf = back["state"].pop("leaf")
    ref_leaf = ref["state"].pop("leaf")
    if case == "bf16":
        assert leaf.dtype == torch.bfloat16
        leaf = leaf.view(torch.int16).numpy()
        ref_leaf = np.asarray(ref_leaf).view(np.int16)
    if case == "empty_dict":
        assert leaf == ref_leaf == {}
    else:
        assert leaf.dtype == ref_leaf.dtype and leaf.shape == ref_leaf.shape
        np.testing.assert_array_equal(leaf, ref_leaf)
    assert back == ref  # every other value, Python scalars and numpy scalar
    assert type(back["scalar"]) is np.float32


@pytest.mark.parametrize("small", ["flax", "port"])
def test_codec_chunked_arrays_both_ways(monkeypatch, small):
    """Arrays above MAX_CHUNK_SIZE split into chunk dicts; whichever side
    writes them, the other reads them back whole."""
    arr = np.random.default_rng(1).normal(size=(5, 7)).astype(np.float32)  # 140 bytes
    tree = {"a": arr, "b": {"c": np.arange(40, dtype=np.int32)}, "s": 1}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    if small == "flax":
        blob = serialization.to_bytes(tree)
        assert flax_msgpack.to_bytes(tree) == blob
        back = flax_msgpack.msgpack_restore(blob)
    else:
        blob = flax_msgpack.to_bytes(tree)
        back = serialization.msgpack_restore(blob)
    assert b"__msgpack_chunked_array__" in blob
    np.testing.assert_array_equal(back["a"], arr)
    np.testing.assert_array_equal(back["b"]["c"], tree["b"]["c"])


def test_codec_rejects_truncated_and_reads_files_writable(tmp_path):
    tree, _ = _codec_tree("f32")
    blob = serialization.to_bytes(tree)
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.msgpack_restore(blob[:-7])
    path = tmp_path / "t.msgpack"
    with open(path, "wb") as f:
        assert flax_msgpack.write(tree, f) == len(blob)
    assert path.read_bytes() == blob
    leaf = flax_msgpack.read(str(path))["state"]["leaf"]
    assert leaf.flags.writeable  # a view of one bytearray, no copy per leaf
    np.testing.assert_array_equal(leaf, tree["state"]["leaf"])


# -------------------------------------------------------------- converters

def test_lm_inverse_converter_matches_the_jax_bridge(lm_params):
    model = TransformerLM(**LM, device="cpu")
    model.load_state_dict(lm_state_dict_from_jax(lm_params))
    sd = model.state_dict()
    got = lm_params_to_jax(sd)
    _assert_trees_equal(got, import_lm_state_dict(sd)["params"])
    _assert_trees_equal(got, lm_params)          # the round trip is exact
    assert list(got) == sorted(got)              # the JAX checkpoint's key order


@pytest.mark.parametrize("block,stem", [("Bottleneck", "conv7"), ("BasicBlock", "conv7"),
                                        ("Bottleneck", "space_to_depth")])
def test_resnet_inverse_converter_matches_the_jax_bridge(block, stem):
    v = _jax_resnet_variables(block, stem)
    model = tr.ResNet(block_cls=getattr(tr, block), stem=stem, device="cpu", **RES)
    model.load_state_dict(resnet_state_dict_from_jax(v["params"], v["batch_stats"]))
    sd = model.state_dict()
    got = resnet_variables_to_jax(sd)
    want = import_resnet_state_dict(sd)
    for key in ("params", "batch_stats"):
        _assert_trees_equal(got[key], want[key])
        _assert_trees_equal(got[key], v[key])
    # Momentum: parameters only, zeros where SGD has made no buffer yet.
    opt = sgd(model.parameters())
    first = next(model.parameters())
    opt.state[first]["momentum_buffer"] = torch.full_like(first, 2.0)
    mom = resnet_params_to_jax(momentum_state_dict(model, opt))
    assert np.all(mom["conv_init"]["kernel"] == 2.0)
    assert not any(np.any(x) for p, x in _leaves(mom) if "conv_init" not in str(p))
    _assert_trees_equal(jax.tree_util.tree_map(np.zeros_like, mom),
                        jax.tree_util.tree_map(np.zeros_like, v["params"]))


# ----------------------------------------------------- across the packages

def _lm_port(params=None, seed=0):
    model = TransformerLM(**LM, device="cpu")
    if params is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(lm_state_dict_from_jax(params))
    return model, sgd(model.parameters())


def _res_port(variables=None):
    model = tr.ResNet(block_cls=tr.Bottleneck, device="cpu", **RES)
    if variables is None:
        model.init_weights(torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(resnet_state_dict_from_jax(variables["params"],
                                                         variables["batch_stats"]))
    return model, sgd(model.parameters())


FT = {"step": 3, "global_step": 11, "sampler_seed": 4, "sampler_epoch": 2, "lr_scale": 0.5}


@pytest.mark.parametrize("family", ["lm", "resnet"])
def test_jax_checkpoint_loads_in_the_port_and_back(tmp_path, lm_params, res_variables, family):
    """JAX writes, the port loads (exact), the port writes the same bytes
    again, and JAX loads the port's file into its TrainState (exact)."""
    if family == "lm":
        variables, arch, (model, opt) = {"params": lm_params}, "transformer_lm", _lm_port(seed=1)
    else:
        variables, arch, (model, opt) = res_variables, "resnet50", _res_port()
    state = TrainState(step=jnp.asarray(11, jnp.int32), params=variables["params"],
                       batch_stats=variables.get("batch_stats", {}),
                       momentum=_random_like(variables["params"], 9))
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_ckpt.save_checkpoint(jax_dir, state, 2, arch, 61.5, is_best=False, ft=FT)
    jax_file = os.path.join(jax_dir, jax_ckpt.CHECKPOINT_NAME)

    step, meta = ckpt.load_checkpoint(jax_file, model, opt)
    assert step == 11
    assert meta == {"epoch": 2, "arch": arch, "best_acc1": 61.5, "ft": FT,
                    "has_residual": False}
    trees = ckpt.state_trees(model, opt)
    _assert_trees_equal(trees["params"], variables["params"])
    _assert_trees_equal(trees["batch_stats"], state.batch_stats)
    _assert_trees_equal(trees["momentum"], state.momentum)

    ckpt.save_checkpoint(port_dir, model, opt, step, meta["epoch"], arch, meta["best_acc1"],
                         is_best=False, ft=meta["ft"])
    port_file = os.path.join(port_dir, ckpt.CHECKPOINT_NAME)
    with open(port_file, "rb") as a, open(jax_file, "rb") as b:
        assert a.read() == b.read()
    assert jax_integrity.verify_sidecar(port_file) is True

    template = TrainState(step=jnp.zeros((), jnp.int32),
                          params=jax.tree_util.tree_map(np.zeros_like, variables["params"]),
                          batch_stats=jax.tree_util.tree_map(np.zeros_like, state.batch_stats),
                          momentum=jax.tree_util.tree_map(np.zeros_like, variables["params"]))
    back, jmeta = jax_ckpt.load_checkpoint(port_file, template)
    assert int(back.step) == 11 and jmeta == {k: v for k, v in meta.items()
                                              if k != "has_residual"}
    _assert_trees_equal(back.params, variables["params"])
    _assert_trees_equal(back.batch_stats, state.batch_stats)
    _assert_trees_equal(back.momentum, state.momentum)


def test_residual_is_dropped_and_missing_ft_defaults(tmp_path, lm_params):
    """A legacy (pre-ft) payload and an error-feedback ``residual`` subtree
    both load; the residual is dropped."""
    payload = {"epoch": 4, "arch": "transformer_lm", "best_acc1": 2.5,
               "state": {"step": np.asarray(3, np.int32), "params": lm_params,
                         "batch_stats": {}, "momentum": _random_like(lm_params, 2),
                         "residual": _random_like(lm_params, 4)}}
    path = str(tmp_path / "legacy.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(payload))
    model, opt = _lm_port(seed=3)
    step, meta = ckpt.load_checkpoint(path, model, opt)
    assert step == 3 and meta["ft"] == ckpt.FT_DEFAULTS and meta["best_acc1"] == 2.5
    _assert_trees_equal(lm_params_to_jax(model.state_dict()), lm_params)
    _assert_trees_equal(ckpt.state_trees(model, opt)["momentum"], payload["state"]["momentum"])


# ----------------------------------------------------------------- integrity

def test_sidecar_digest_is_the_same_from_both_packages(tmp_path):
    a, b = tmp_path / "a.msgpack", tmp_path / "b.msgpack"
    a.write_bytes(b"checkpoint bytes" * 100)
    b.write_bytes(a.read_bytes())
    integrity.write_sidecar(str(a))
    jax_integrity.write_sidecar(str(b))
    assert (tmp_path / "a.msgpack.sha256").read_text() == \
        (tmp_path / "b.msgpack.sha256").read_text()
    assert jax_integrity.verify_sidecar(str(a)) is True and integrity.verify_sidecar(str(b))


def test_rotation_sidecars_and_ft_round_trip(tmp_path):
    model, opt = _lm_port()
    d = str(tmp_path)
    ckpt.save_checkpoint(d, model, opt, 7, 2, "transformer_lm", 1.5, False, ft=FT)
    ckpt.save_checkpoint(d, model, opt, 8, 3, "transformer_lm", 1.5, False)
    latest, prev = os.path.join(d, ckpt.CHECKPOINT_NAME), os.path.join(d, ckpt.PREV_NAME)
    assert integrity.verify_sidecar(latest) is True and integrity.verify_sidecar(prev) is True
    assert not os.path.exists(latest + ".tmp")
    step, meta = ckpt.load_checkpoint(prev, _lm_port(seed=1)[0])
    assert (step, meta["epoch"], meta["ft"]) == (7, 2, FT)
    step, meta = ckpt.load_checkpoint(latest, _lm_port(seed=1)[0])
    assert (step, meta["epoch"], meta["ft"]["step"]) == (8, 3, 0)


@pytest.mark.parametrize("mode", ["flip", "truncate"])
def test_corrupt_latest_falls_back_to_prev(tmp_path, mode):
    model, opt = _lm_port()
    d = str(tmp_path)
    ckpt.save_checkpoint(d, model, opt, 2, 5, "transformer_lm", 0.0, False,
                         ft={"step": 2, "global_step": 2})
    saved = model.embed.weight.detach().clone()
    with torch.no_grad():
        model.embed.weight.add_(1.0)
    ckpt.save_checkpoint(d, model, opt, 3, 6, "transformer_lm", 0.0, False)
    latest = os.path.join(d, ckpt.CHECKPOINT_NAME)
    corrupt_file(latest, mode=mode, seed=9)
    fresh = _lm_port(seed=1)[0]
    with pytest.warns(UserWarning, match="falling back"):
        _, meta = ckpt.load_checkpoint(latest, fresh)
    assert meta["epoch"] == 5 and meta["ft"]["step"] == 2
    assert torch.equal(fresh.embed.weight, saved)
    corrupt_file(os.path.join(d, ckpt.PREV_NAME), mode=mode, seed=9)
    with pytest.raises(integrity.CheckpointCorruptError):
        with pytest.warns(UserWarning, match="falling back"):
            ckpt.load_checkpoint(latest, fresh)


def test_legacy_without_sidecar_loads_and_corrupt_legacy_is_reported(tmp_path, lm_params):
    payload = {"epoch": 4, "arch": "transformer_lm", "best_acc1": 2.5,
               "state": {"step": np.asarray(0, np.int32), "params": lm_params,
                         "batch_stats": {}, "momentum": lm_params}}
    p = str(tmp_path / "legacy.msgpack")
    with open(p, "wb") as f:
        f.write(serialization.to_bytes(payload))
    _, meta = ckpt.load_checkpoint(p, _lm_port()[0])
    assert meta["epoch"] == 4 and meta["ft"]["lr_scale"] == 1.0
    corrupt_file(p, mode="truncate", seed=2)
    with pytest.raises(integrity.CheckpointCorruptError):
        ckpt.load_checkpoint(p, _lm_port()[0])
    # A verified file that does not fit the model is an arch mismatch, not
    # corruption: it raises as it is.
    model, opt = _lm_port()
    ckpt.save_checkpoint(str(tmp_path), model, opt, 0, 0, "transformer_lm", 0.0, False)
    other = TransformerLM(**dict(LM, d_model=16), device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        ckpt.load_checkpoint(str(tmp_path / ckpt.CHECKPOINT_NAME), other)


def test_model_best_written_atomically_with_sidecar(tmp_path):
    model, opt = _lm_port()
    ckpt.save_checkpoint(str(tmp_path), model, opt, 0, 0, "transformer_lm", 1.0, True)
    best = tmp_path / ckpt.BEST_NAME
    assert integrity.verify_sidecar(str(best)) is True
    assert not (tmp_path / (ckpt.BEST_NAME + ".tmp")).exists()
    assert best.read_bytes() == (tmp_path / ckpt.CHECKPOINT_NAME).read_bytes()


def test_orbax_is_refused_with_its_reason(tmp_path):
    model, _ = _lm_port()
    with pytest.raises(NotImplementedError, match="orbax.checkpoint imports JAX"):
        ckpt.load_checkpoint(str(tmp_path), model)
    with pytest.raises(SystemExit, match="orbax"):
        lm_pretrain.main(TINY_LM + ["--resume", str(tmp_path)])


# --------------------------------------------------------------- resume

TINY_LM = ["--device", "cpu", "--vocab", "64", "--d-model", "32", "--n-heads", "4",
           "--n-layers", "1", "--seq-len", "16", "-b", "4", "-p", "1", "--no-eval",
           "--clip-grad-norm", "1"]


def _assert_close_state(got_model, got_opt, want_model, want_opt):
    for (name, a), b in zip(got_model.state_dict().items(), want_model.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7, err_msg=name)
    for (name, a), b in zip(momentum_state_dict(got_model, got_opt).items(),
                            momentum_state_dict(want_model, want_opt).values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7, err_msg=name)


def test_lm_save_steps_and_resume_match_an_uninterrupted_run(tmp_path):
    d = str(tmp_path / "lm")
    ref = lm_pretrain.run(TINY_LM + ["--steps", "6"])
    first = lm_pretrain.run(TINY_LM + ["--steps", "4", "--save-steps", "2",
                                       "--checkpoint-dir", d])
    assert os.path.exists(os.path.join(d, ckpt.PREV_NAME))
    resumed = lm_pretrain.run(TINY_LM + ["--steps", "6", "--resume",
                                         os.path.join(d, ckpt.CHECKPOINT_NAME)])
    assert resumed._start_step == 4 and len(resumed.losses) == 2
    want = [float(x) for x in ref.losses]
    assert [float(x) for x in first.losses] == pytest.approx(want[:4], rel=1e-6)
    assert [float(x) for x in resumed.losses] == pytest.approx(want[4:], rel=1e-6)
    _assert_close_state(resumed.model, resumed.optimizer, ref.model, ref.optimizer)


# f32: on the CPU, torch's bf16 convolution backward leaves uninitialised
# values in the weight gradient of taps that see only padding (a 3x3
# stride-2 conv on a 1x1 plane, resnet18's layer4.0.conv1 here), which
# differ from run to run; f32 writes zeros there.
TINY_IMG = ["--device", "cpu", "-a", "resnet18", "--synthetic", "--image-size", "16",
            "-b", "4", "--synthetic-length", "16", "--epochs", "1", "-p", "2", "-j", "2",
            "--num-classes", "10", "--seed", "1", "--precision", "fp32", "--fused-convbn"]


def test_image_mid_epoch_resume_matches_an_uninterrupted_epoch(tmp_path):
    """A 4-step epoch stopped after step 2 (the --save-steps 2 checkpoint)
    and resumed reruns the same epoch from step 3 on the same batches."""
    run_dir = ["--checkpoint-dir", str(tmp_path / "a"), "--epoch-csv", str(tmp_path / "e.csv")]
    ref = Trainer(parse_config(TINY_IMG + run_dir))
    ref.fit()
    d = str(tmp_path / "b")
    first = Trainer(parse_config(TINY_IMG + ["--checkpoint-dir", d, "--save-steps", "2"]))
    assert first.train_epoch(0, stop_after=2) == 2
    path = os.path.join(d, ckpt.CHECKPOINT_NAME)
    step, meta = ckpt.load_checkpoint(path, first.model)
    assert (step, meta["epoch"], meta["ft"]["step"], meta["ft"]["sampler_seed"]) == (2, 0, 2, 1)
    resumed = Trainer(parse_config(TINY_IMG + ["--checkpoint-dir", d, "--resume", path,
                                               "--epoch-csv", str(tmp_path / "e.csv")]))
    assert (resumed.cfg.start_epoch, resumed._resume_step, resumed.global_step) == (0, 2, 2)
    resumed.fit()
    want = [float(x) for x in ref.losses]
    assert [float(x) for x in first.losses + resumed.losses] == pytest.approx(want, rel=1e-6)
    _assert_close_state(resumed.model, resumed.optimizer, ref.model, ref.optimizer)
    # The epoch-end checkpoint starts the next epoch on resume.
    _, meta = ckpt.load_checkpoint(path, first.model)
    assert (meta["epoch"], meta["ft"]["step"], meta["ft"]["global_step"]) == (0, 0, 4)


def test_iter_batches_skips_by_index_and_checks_its_range():
    loader = DataLoader(SyntheticImageDataset(10, 3, 4, seed=0), 2, num_workers=1)
    full = list(loader)
    tail = list(loader.iter_batches(3))
    assert len(tail) == 2
    for a, b in zip(tail, full[3:]):
        np.testing.assert_array_equal(a["images"], b["images"])
    with pytest.raises(ValueError, match="out of range"):
        next(loader.iter_batches(6))


def test_pretrained_loads_weights_or_names_the_missing_file(tmp_path, monkeypatch):
    cfg = TINY_IMG + ["--checkpoint-dir", str(tmp_path)]
    src = Trainer(parse_config(cfg))
    ckpt.save_checkpoint(str(tmp_path), src.model, src.optimizer, 0, 0, "resnet18", 0.0, False)
    os.replace(tmp_path / ckpt.CHECKPOINT_NAME, tmp_path / "resnet18.msgpack")
    monkeypatch.setenv("PTD_TPU_PRETRAINED_DIR", str(tmp_path))
    other = Trainer(parse_config([a if a != "1" else "2" for a in cfg] + ["--pretrained"]))
    for name, t in src.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[name], t), name
    monkeypatch.setenv("PTD_TPU_PRETRAINED_DIR", str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError, match="--pretrained: no weights at"):
        Trainer(parse_config(cfg + ["--pretrained"]))


# ------------------------------------------------------- sampling, serving

@pytest.fixture(scope="module")
def jax_lm_file(tmp_path_factory, lm_params):
    d = str(tmp_path_factory.mktemp("jax_lm"))
    state = TrainState(step=jnp.asarray(9, jnp.int32), params=lm_params, batch_stats={},
                       momentum=_random_like(lm_params, 1))
    jax_ckpt.save_checkpoint(d, state, 0, "transformer_lm", 0.0, is_best=False)
    return os.path.join(d, jax_ckpt.CHECKPOINT_NAME)


def _tokens_line(main, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        assert main(argv) == 0
    return re.search(r"^tokens: (.*)$", out.getvalue(), re.M).group(1)


def test_lm_generate_resume_matches_jax_on_a_jax_file(jax_lm_file):
    argv = ["--resume", jax_lm_file, "--vocab", "64", "--d-model", "32", "--n-heads", "4",
            "--n-layers", "1", "--prompt-tokens", "5,17,3,40", "-n", "8"]
    want = _tokens_line(jax_lm_generate.main, argv)
    assert _tokens_line(lm_generate.main, argv + ["--device", "cpu"]) == want
    with pytest.raises(SystemExit, match="provide --resume CHECKPOINT"):
        lm_generate.main(argv[2:] + ["--device", "cpu"])


def test_serve_lm_serves_a_checkpoint(jax_lm_file, tmp_path, capsys):
    toy = ["--device", "cpu", "--requests", "4", "--rate-rps", "400", "--max-new-tokens", "4",
           "--n-heads", "4"]
    assert serve_lm.main(toy + ["--checkpoint", jax_lm_file]) == 0
    assert '"completed": 4' in capsys.readouterr().out
    params, vocab, d_model, n_layers = serve_lm.load_checkpoint_params(jax_lm_file, "cpu")
    assert (vocab, d_model, n_layers) == (64, 32, 1)
    model = TransformerLM(**LM, device="cpu")
    model.load_state_dict(params)
    bare = tmp_path / "resnet.msgpack"
    bare.write_bytes(serialization.to_bytes({"conv_init": {"kernel": np.zeros(3)}}))
    with pytest.raises(SystemExit, match="missing 'embed'"):
        serve_lm.main(toy + ["--checkpoint", str(bare)])
