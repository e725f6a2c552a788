"""The kernel build's cache key (qppvm_tpu_torch/build.py), without nvcc.

A built library is reused only while its source, every header under
``csrc/`` and the flags are unchanged: an edited header must give a new
name, so the stale library is not loaded.
"""
from qppvm_tpu_torch import build


def test_digest_changes_with_the_source_and_every_header(tmp_path):
    (tmp_path / "k.cu").write_text('#include "tile.cuh"\n')
    (tmp_path / "tile.cuh").write_text("// v1\n")
    first = build.digest("k", tmp_path)
    assert build.digest("k", tmp_path) == first
    (tmp_path / "tile.cuh").write_text("// v2\n")
    second = build.digest("k", tmp_path)
    assert second != first
    (tmp_path / "more.cuh").write_text("// new header\n")
    third = build.digest("k", tmp_path)
    assert third not in (first, second)
    (tmp_path / "k.cu").write_text('#include "tile.cuh" // edited\n')
    fourth = build.digest("k", tmp_path)
    assert fourth not in (first, second, third)
    (tmp_path / "notes.txt").write_text("not a source\n")
    assert build.digest("k", tmp_path) == fourth


def test_library_path_is_named_by_the_digest(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    built = tmp_path / f"level_qp_{build.digest('level_qp')}.so"
    built.write_bytes(b"")   # present, so library_path does not build
    assert build.library_path("level_qp") == built
