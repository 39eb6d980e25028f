"""Build the port's CUDA sources (`opensearch_tpu_torch/csrc/*.cu`) with
nvcc into shared libraries with a plain C interface, and load them with
ctypes.

Each library is built at first use into `opensearch_tpu_torch/_build/`,
named by a hash of its source, every header it includes from `csrc/` and
the flags, so an edited source or shared header never loads a stale
binary.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# library -> C function -> (restype, argtypes)
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "bm25_tfdl": {
        "bm25_tfdl_launch": (_I, [_P, _P, _L,
                                  _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _F, _F, _F,
                                  _I, _P, _P, _P, _P,
                                  _I, _P, _P, _P, _P]),
        "bm25_tfdl_resident_blocks": (_I, [_P, _P]),
        "bm25_tfdl_error_string": (ctypes.c_char_p, [_I]),
    },
    "bm25_impact": {
        "bm25_impact_launch": (_I, [_P, _P, _L,
                                    _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I,
                                    _I, _P, _P, _P, _P,
                                    _I, _P, _P, _P, _P]),
        "bm25_impact_resident_blocks": (_I, [_P, _P]),
        "bm25_impact_error_string": (ctypes.c_char_p, [_I]),
    },
    "bm25_bool": {
        "bm25_bool_launch": (_I, [_P, _P, _L, _P, _L, _P, _L,
                                  _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _F, _F, _F,
                                  _I, _P, _P, _P, _P,
                                  _I, _P, _P, _P, _P]),
        "bm25_bool_resident_blocks": (_I, [_P, _P]),
        "bm25_bool_error_string": (ctypes.c_char_p, [_I]),
    },
    "bm25_norms": {
        "bm25_norms_launch": (_I, [_P, _P, _L,
                                   _P, _P, _P, _P,
                                   _I, _I, _I, _I,
                                   _I, _P, _P, _P, _P,
                                   _I, _P, _P, _P, _P]),
        "bm25_norms_resident_blocks": (_I, [_P, _P]),
        "bm25_norms_error_string": (ctypes.c_char_p, [_I]),
    },
}
_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card")
    return found


def sources(name: str) -> list:
    """The `.cu` of library `name` and every header it includes from
    `csrc/` (quoted includes, followed transitively), in include order."""
    out = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in out:
            continue
        out.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = CSRC / inc.decode()
            if dep.exists():
                todo.append(dep)
    return out


def library_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(name: str) -> str:
    """Compile library `name` unless its binary exists. Returns nvcc's
    ptxas report ("" when nothing was compiled); raises with nvcc's output
    on a failure."""
    out = library_path(name)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"CUDA build of {name} failed: nvcc exited "
                           f"{proc.returncode}\n{proc.stdout}")
    os.replace(tmp, out)
    return proc.stdout


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if it has no binary."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is not None:
            return lib
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = argtypes
        _LOADED[name] = lib
        return lib
