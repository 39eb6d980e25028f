"""The port's CUDA build naming (opensearch_tpu_torch/ops/_build.py): a
library's binary is named by a hash of its `.cu`, every header it includes
from `csrc/`, and the flags, so an edited shared header rebuilds every
library that includes it. No nvcc is needed: only the names are computed.
"""

import ctypes
import re
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


_PROTO = re.compile(r"^([A-Za-z_][\w ]*?[\w*])\s*\b(\w+)\(([^)]*)\)\s*\{",
                    re.M)


def _c_prototypes() -> dict:
    """name -> (return type, [argument types]) of every function in the
    `extern "C"` blocks of csrc/*.cu."""
    out = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        text = path.read_text()
        block = text[text.index('extern "C" {'):]
        for ret, name, args in _PROTO.findall(block):
            types = []
            for arg in " ".join(args.split()).split(","):
                arg = arg.strip()
                if arg:
                    # drop the parameter name
                    types.append(re.sub(r"\s*\b\w+$", "", arg).strip())
            out[name] = (ret.strip(), types)
    return out


def _ctype_of(c_type: str):
    if "*" in c_type:
        return (ctypes.c_char_p if c_type.replace(" ", "") == "constchar*"
                else ctypes.c_void_p)
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}[c_type]


def test_signatures_match_the_c_prototypes():
    """Every SIGNATURES entry has the arity of its C prototype, a pointer
    type where the C side has a pointer and c_longlong where it has
    `long long`: an argtypes list out of step with the prototype cuts
    pointers silently."""
    protos = _c_prototypes()
    assert set(protos) == {fn for lib in _build.SIGNATURES.values()
                           for fn in lib}
    for lib, fns in _build.SIGNATURES.items():
        for fn, (restype, argtypes) in fns.items():
            ret, args = protos[fn]
            assert restype is _ctype_of(ret), (fn, ret)
            assert len(argtypes) == len(args), (fn, len(argtypes), len(args))
            for i, (py, c) in enumerate(zip(argtypes, args)):
                assert py is _ctype_of(c), (fn, i, c, py)


def test_prototype_parser_sees_a_mismatch(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    src = csrc / "bm25_impact.cu"
    text = src.read_text()
    # a pointer argument dropped from the C side
    src.write_text(text.replace("int split, float* part_s,", "int split,"))
    ret, args = _c_prototypes()["bm25_impact_launch"]
    want = _build.SIGNATURES["bm25_impact"]["bm25_impact_launch"][1]
    assert len(args) == len(want) - 1
