"""The port's ImageFolder, C++ data plane, DataLoader and DeviceFeeder
against the JAX package's, on trees of small images written here with PIL.

- ``ImageFolder``: the same classes, ``class_to_idx`` and samples on a tree
  with nested directories, upper-case extensions and non-image files; the
  same ``get`` results per mode (f32 and u8 stacks, native train and eval)
  under the same rng.  Exact.
- The C++ plane: ``normalize_batch`` and ``decode_crop_resize_batch`` equal
  the JAX plane's bit for bit (flip, threads, train draws, eval, a corrupt
  blob masked).
- ``DataLoader``: batches equal the JAX loader's bit for bit for every
  ``batch_mode`` (f32, u8_host, u8_wire, and a native-decode tree with a
  corrupt file) under thread workers, and under two spawned worker
  processes (the only test that spawns), padded tail and masks included.
  A spawned worker skips the parent's main module unless the dataset
  pickles a reference to it.
- ``DeviceFeeder`` on a uint8 batch: within 1e-6 of the JAX feeder's
  on-device normalize (both f32; XLA may fold the constants differently).
"""

import io
import os
import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from pytorch_distributed_tpu.data import DataLoader as JaxLoader
from pytorch_distributed_tpu.data import DeviceFeeder as JaxFeeder
from pytorch_distributed_tpu.data import DistributedShardSampler as JaxSampler
from pytorch_distributed_tpu.data import ImageFolder as JaxFolder
from pytorch_distributed_tpu.data import native as jax_native
from pytorch_distributed_tpu.data import transforms as jt
from pytorch_distributed_tpu.parallel import MeshSpec, build_mesh
from pytorch_distributed_tpu_torch.data import (
    DataLoader,
    DeviceFeeder,
    DistributedShardSampler,
    ImageFolder,
)
from pytorch_distributed_tpu_torch.data import native
from pytorch_distributed_tpu_torch.data import transforms as tt

MEAN, STD = tt.IMAGENET_MEAN, tt.IMAGENET_STD


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(path, rng, fmt):
    h, w = (int(v) for v in rng.integers(20, 90, 2))
    arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr).save(path, format=fmt)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Two classes (listed out of order), a nested directory, upper- and
    lower-case extensions, JPEG and PNG files, and files that are not
    images; 11 images in all."""
    root = tmp_path_factory.mktemp("folder")
    rng = np.random.default_rng(0)
    for name, fmt in [("zeta/a.JPEG", "JPEG"), ("zeta/b.png", "PNG"), ("zeta/c.jpg", "JPEG"),
                      ("zeta/deep/er/d.PNG", "PNG"), ("zeta/deep/e.jpeg", "JPEG"),
                      ("alpha/x.JPG", "JPEG"), ("alpha/y.ppm", "PPM"), ("alpha/z.JPEG", "JPEG"),
                      ("alpha/sub/w.png", "PNG"), ("alpha/sub/v.JPEG", "JPEG"),
                      ("alpha/u.Jpeg", "JPEG")]:
        _write(root / name, rng, fmt)
    (root / "zeta" / "notes.txt").write_text("not an image")
    (root / "alpha" / "sub" / "a.JPEG.bak").write_bytes(b"not listed")
    (root / "README").write_text("a file at the root is not a class")
    return root


def _folders(root, **kw):
    return JaxFolder(str(root), **kw), ImageFolder(str(root), **kw)


def test_imagefolder_lists_the_jax_samples(tree):
    j, t = _folders(tree)
    assert t.classes == j.classes == ["alpha", "zeta"]
    assert t.class_to_idx == j.class_to_idx
    assert t.samples == j.samples and len(t) == 11


@pytest.mark.parametrize("kw", [
    dict(transform=tt.train_transform(24)), dict(transform=tt.eval_transform(24, 28)),
    dict(transform=tt.train_transform_u8(24)), dict(transform=tt.eval_transform_u8(24, 28)),
    dict(transform=None), dict(native_decode=True, image_size=24),
    dict(native_decode=True, image_size=24, native_augment=False)],
    ids=["f32-train", "f32-eval", "u8-train", "u8-eval", "none", "native-train",
         "native-eval"])
def test_imagefolder_get_matches_jax(tree, kw):
    kw = dict(kw)
    port_tf = kw.pop("transform", None)
    j, t = _folders(tree, **kw)
    t.transform = port_tf
    j.transform = None if port_tf is None else _jax_stack(port_tf)
    for i in range(len(t)):
        want = j.get(i, np.random.default_rng((1, i)))
        got = t.get(i, np.random.default_rng((1, i)))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if isinstance(w, np.ndarray):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
            else:
                assert g == w


def _jax_stack(port_stack):
    """The JAX stack with the same classes and sizes as ``port_stack``."""
    parts = []
    for p in port_stack.transforms:
        cls = getattr(jt, type(p).__name__)
        args = [p.size] if hasattr(p, "size") else []
        parts.append(cls(*args))
    return jt.Compose(parts)


def _jpegs(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        h, w = (int(v) for v in rng.integers(24, 120, 2))
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, "JPEG")
        out.append(buf.getvalue())
    return out


def test_cpp_plane_matches_the_jax_plane():
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (6, 9, 13, 3), dtype=np.uint8)
    flip = (rng.random(6) < 0.5).astype(np.uint8)
    for fl in (None, flip):
        for threads in (1, 3):
            np.testing.assert_array_equal(
                native.normalize_batch(u8, MEAN, STD, flip=fl, n_threads=threads),
                jax_native.normalize_batch(u8, MEAN, STD, flip=fl, n_threads=threads))
    assert native.jpeg_native_available() and jax_native.jpeg_native_available()
    blobs = _jpegs(5)
    blobs[2] = b"\xff\xd8\xff corrupt"
    params = np.stack([[rng.uniform(0.08, 1), rng.uniform(np.log(3 / 4), np.log(4 / 3)),
                        rng.random(), rng.random()] for _ in blobs]).astype(np.float32)
    for p in (params, None):
        got, gfail = native.decode_crop_resize_batch(blobs, 32, params=p, return_failed=True,
                                                     n_threads=2)
        want, wfail = jax_native.decode_crop_resize_batch(blobs, 32, params=p,
                                                          return_failed=True)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(gfail, wfail)
        assert gfail.tolist() == [False, False, True, False, False] and not got[2].any()


def _loader_pair(jds, tds, mode, worker_type="thread", flip=False, n=11):
    kw = dict(num_workers=2, seed=5, batch_mode=mode, random_flip=flip)
    jl = JaxLoader(jds, 4, sampler=JaxSampler(n, shuffle=True, seed=5), **kw)
    tl = DataLoader(tds, 4, sampler=DistributedShardSampler(n, shuffle=True, seed=5),
                    worker_type=worker_type, **kw)
    return jl, tl


def _same_batches(jl, tl, epoch=1):
    jl.set_epoch(epoch)
    tl.set_epoch(epoch)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the corrupt-JPEG warning
        jb, tb = list(jl), list(tl)
    assert len(tb) == len(jb) == 3  # 11 samples in batches of 4: a padded tail
    for a, b in zip(tb, jb):
        for key in ("images", "labels", "weights"):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    return tb


def _datasets(tree, mode):
    if mode == "native":
        return _folders(tree, native_decode=True, image_size=24)
    j, t = _folders(tree)
    if mode == "f32":
        t.transform, j.transform = tt.train_transform(24), jt.train_transform(24)
    else:
        t.transform, j.transform = tt.train_transform_u8(24), jt.train_transform_u8(24)
    return j, t


@pytest.mark.parametrize("mode,batch_mode", [
    ("f32", "f32"), ("u8", "u8_host"), ("u8", "u8_wire"), ("native", "u8_wire"),
    ("native", "u8_host")])
def test_loader_batches_match_jax(tree, mode, batch_mode):
    jds, tds = _datasets(tree, mode)
    tb = _same_batches(*_loader_pair(jds, tds, batch_mode, flip=batch_mode != "f32"))
    assert tb[-1]["weights"].tolist() == [1, 1, 1, 0]
    assert tb[0]["images"].dtype == (np.uint8 if batch_mode == "u8_wire" else np.float32)


def test_native_loader_masks_a_corrupt_jpeg_as_jax_does(tmp_path):
    rng = np.random.default_rng(4)
    for i in range(5):
        _write(tmp_path / "c0" / f"{i}.jpg", rng, "JPEG")
    (tmp_path / "c0" / "5.jpg").write_bytes(b"garbage, not a jpeg")
    _write(tmp_path / "c1" / "6.JPEG", rng, "PNG")  # a PNG named .JPEG: masked too
    jds, tds = _folders(tmp_path, native_decode=True, image_size=16, native_augment=False)
    jl, tl = _loader_pair(jds, tds, "u8_wire", n=7)
    jl.sampler = JaxSampler(7, shuffle=False)
    tl.sampler = DistributedShardSampler(7, shuffle=False)
    jl.batch_size = tl.batch_size = 8
    jl.set_epoch(0)
    tl.set_epoch(0)
    with pytest.warns(UserWarning, match="2 corrupt JPEG"):
        (got,) = list(tl)
    with pytest.warns(UserWarning):
        (want,) = list(jl)
    assert got["weights"].tolist() == [1, 1, 1, 1, 1, 0, 0, 0]
    for key in ("images", "labels", "weights"):
        np.testing.assert_array_equal(got[key], want[key])


def test_process_workers_match_jax(tree):
    """Two spawned workers; one pool per dataset, kept across batch modes
    and epochs, and closed."""
    jds, tds = _datasets(tree, "u8")
    jl, tl = _loader_pair(jds, tds, "u8_host", worker_type="process", flip=True)
    _same_batches(jl, tl)
    pool = tl._pool
    jl.batch_mode = tl.batch_mode = "u8_wire"
    _same_batches(jl, tl, epoch=2)
    assert tl._pool is pool
    for mode in ("f32", "native"):
        jl.dataset, tl.dataset = _datasets(tree, mode)
        jl.batch_mode = tl.batch_mode = "f32" if mode == "f32" else "u8_wire"
        _same_batches(jl, tl)
        assert tl._pool is not pool
        pool = tl._pool
    tl.close()
    assert tl._pool is None


_MAIN = r'''
import os, sys
if __name__ == "__mp_main__":
    open(os.environ["MAIN_RAN"], "w").close()
from pytorch_distributed_tpu_torch.data import DataLoader, SyntheticImageDataset


class Local(SyntheticImageDataset):
    pass


if __name__ == "__main__":
    kind = Local if os.environ["DATASET"] == "local" else SyntheticImageDataset
    loader = DataLoader(kind(length=4, num_classes=2, image_size=8), 4, num_workers=1,
                        worker_type="process")
    (batch,) = list(loader)
    loader.close()
    print(batch["images"].shape)
'''


@pytest.mark.parametrize("dataset, how, runs_main", [("package", "-m", False),
                                                      ("local", "file", True)])
def test_spawned_workers_run_the_main_module_only_when_needed(tmp_path, dataset, how,
                                                               runs_main):
    """The workers of a script run with ``python -m`` (found by
    ``__spec__``) or as a file (``__file__``) do not run it first, so they
    import no torch, unless the dataset's class lives in that script."""
    (tmp_path / "main_script.py").write_text(_MAIN)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, MAIN_RAN=str(tmp_path / "ran"), DATASET=dataset,
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = ["-m", "main_script"] if how == "-m" else [str(tmp_path / "main_script.py")]
    out = subprocess.run([sys.executable, *cmd], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["(4,", "8,", "8,", "3)"]
    assert (tmp_path / "ran").exists() == runs_main


def test_feeder_normalizes_uint8_as_the_jax_feeder():
    rng = np.random.default_rng(2)
    batch = {"images": rng.integers(0, 256, (4, 6, 5, 3), dtype=np.uint8),
             "labels": np.arange(4, dtype=np.int32),
             "weights": np.array([1, 1, 1, 0], np.float32)}
    mesh = build_mesh(MeshSpec(("data",), (1,)), jax.devices()[:1])
    (want,) = list(JaxFeeder(mesh)(iter([batch])))
    (got,) = list(DeviceFeeder("cpu")(iter([batch])))
    assert got["images"].dtype == torch.float32
    np.testing.assert_allclose(got["images"].numpy(), np.asarray(want["images"]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(got["labels"].numpy(), batch["labels"])
