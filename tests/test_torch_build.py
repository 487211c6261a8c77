"""The kernel build's library name covers the shared headers: an edited
``csrc/*.cuh`` must give every source a new library, so that no stale
``.so`` built from the old header is loaded.  No nvcc needed."""

from pytorch_distributed_tpu_torch.ops import _build


def test_target_changes_with_every_header(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// helpers\n")
    first = _build._target("k")
    assert first == _build._target("k") and first.parent == tmp_path / "build"
    (tmp_path / "h.cuh").write_text("// helpers, edited\n")
    edited = _build._target("k")
    assert edited != first
    (tmp_path / "g.cuh").write_text("// a new header\n")
    assert _build._target("k") not in (first, edited)
    (tmp_path / "notes.txt").write_text("not a header")
    unchanged = _build._target("k")
    (tmp_path / "notes.txt").write_text("still not a header")
    assert _build._target("k") == unchanged
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert _build._target("k") != unchanged
