"""The port's CUDA build naming (opensearch_tpu_torch/ops/_build.py): a
library's binary is named by a hash of its `.cu`, every header it includes
from `csrc/`, and the flags, so an edited shared header rebuilds every
library that includes it. No nvcc is needed: only the names are computed.
"""

import shutil

from opensearch_tpu_torch.ops import _build


def _copy_csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    return csrc


def test_every_library_lists_the_shared_header(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    for name in _build.SIGNATURES:
        srcs = _build.sources(name)
        assert srcs[0] == csrc / f"{name}.cu"
        assert csrc / "bm25_rows.cuh" in srcs


def test_header_edit_renames_both_libraries(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    names = sorted(_build.SIGNATURES)
    assert names == ["bm25_bool", "bm25_impact", "bm25_norms", "bm25_tfdl"]
    before = {n: _build.library_path(n) for n in names}
    assert before == {n: _build.library_path(n) for n in names}
    hdr = csrc / "bm25_rows.cuh"
    hdr.write_bytes(hdr.read_bytes() + b"\n// edited\n")
    after = {n: _build.library_path(n) for n in names}
    for n in names:
        assert after[n] != before[n], n
        assert after[n].name.startswith(f"{n}-")
    # an edit to one library's own source renames that library only
    src = csrc / "bm25_impact.cu"
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    again = {n: _build.library_path(n) for n in names}
    assert again["bm25_impact"] != after["bm25_impact"]
    for n in ("bm25_bool", "bm25_norms", "bm25_tfdl"):
        assert again[n] == after[n], n
    # the tf.dl contribution header renames B1 and B3 only
    hdr = csrc / "bm25_tfdl.cuh"
    hdr.write_bytes(hdr.read_bytes() + b"\n// edited\n")
    third = {n: _build.library_path(n) for n in names}
    assert {n for n in names if third[n] != again[n]} \
        == {"bm25_bool", "bm25_tfdl"}


def test_unrelated_file_keeps_the_names(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    before = {n: _build.library_path(n) for n in _build.SIGNATURES}
    (csrc / "unrelated.cuh").write_text("// not included anywhere\n")
    assert before == {n: _build.library_path(n) for n in _build.SIGNATURES}
