"""
The host libraries the port builds from the repository's C++ sources in
``native/`` (read, never edited): so far ``align`` (``native/align/
align.cpp``: Smith-Waterman for the accuracy metric), bound with ctypes.

Each is compiled with g++ at first use into ``bonito_tpu_torch/build/``,
named by the source's content hash so a stale build never loads. A failed
build raises: there is no fallback.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
NATIVE = PACKAGE.parent / "native"
BUILD = PACKAGE / "build"
FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]

_loaded = {}
_lock = threading.Lock()


def _bind_align(lib):
    i32, i64, c_char_p = ctypes.c_int32, ctypes.c_int64, ctypes.c_char_p
    p_i32 = ctypes.POINTER(i32)
    lib.sw_align.restype = ctypes.c_int
    lib.sw_align.argtypes = [
        c_char_p, i32, c_char_p, i32,
        i32, i32, i32, i32, i64,
        p_i32, p_i32, p_i32, p_i32, p_i32,
        c_char_p, p_i32, i32,
    ]


SPECS = {"align": (["align/align.cpp"], _bind_align)}


def build(name):
    """Compile library ``name`` if this source has not been; its path."""
    sources = [NATIVE / s for s in SPECS[name][0]]
    digest = hashlib.sha1()
    for src in sources:
        digest.update(src.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    out = BUILD / f"lib{name}-{digest.hexdigest()[:12]}.so"
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = BUILD / f"{out.name}.{os.getpid()}-{threading.get_ident()}.tmp"
    proc = subprocess.run(["g++", *FLAGS, *map(str, sources), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {name}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def load(name):
    """The loaded library ``name`` (built at first use)."""
    with _lock:
        if name not in _loaded:
            lib = ctypes.CDLL(str(build(name)))
            SPECS[name][1](lib)
            _loaded[name] = lib
    return _loaded[name]
