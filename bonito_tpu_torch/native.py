"""
The host libraries the port builds from the repository's C++ sources in
``native/`` (read, never edited), bound with ctypes: ``align``
(``native/align/align.cpp``: Smith-Waterman for the accuracy metric and
the global edit alignment of ``duplex``),
``vbz`` (``native/vbz/vbz.cpp``: the svb16 layer of pod5's VBZ signal
codec), ``mapper`` (``native/mapper/mapper.cpp``: the minimiser
mapper of the basecaller's ``--reference`` stage), ``ctcbeam``
(``native/ctc/ctcbeam.cpp``: the conv-CTC family's prefix beam search)
and ``rans`` (``native/rans/rans.cpp``: the rANS codec of CRAM's blocks).

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
    lib.nw_align.restype = ctypes.c_int
    lib.nw_align.argtypes = [
        c_char_p, i32, c_char_p, i32, i64, p_i32,
        c_char_p, p_i32, i32,
    ]


def _bind_vbz(lib):
    size_t, u8p = ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint8)
    lib.svb16_max_encoded_size.restype = size_t
    lib.svb16_max_encoded_size.argtypes = [size_t]
    lib.svb16_encode_dz.restype = size_t
    lib.svb16_encode_dz.argtypes = [ctypes.POINTER(ctypes.c_int16), size_t,
                                    u8p]
    lib.svb16_decode_dz.restype = ctypes.c_int
    lib.svb16_decode_dz.argtypes = [u8p, size_t,
                                    ctypes.POINTER(ctypes.c_int16), size_t]


def _bind_mapper(lib):
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    p_i32, p_i64 = ctypes.POINTER(i32), ctypes.POINTER(i64)
    lib.mapper_index_build.restype = ctypes.c_void_p
    lib.mapper_index_build.argtypes = [ctypes.c_char_p, i64, p_i64, i32, i32,
                                       i32]
    lib.mapper_index_free.restype = None
    lib.mapper_index_free.argtypes = [ctypes.c_void_p]
    lib.mapper_map.restype = i32
    lib.mapper_map.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, i64,
        p_i32, p_i64, p_i64, p_i32, p_i32, p_i32, p_i32, p_i32, p_i32,
        ctypes.c_char_p, i32, ctypes.c_char_p, i32,
    ]


def _bind_ctcbeam(lib):
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    lib.ctc_beam_search.restype = ctypes.c_int
    lib.ctc_beam_search.argtypes = [
        ctypes.POINTER(ctypes.c_float), i32, i32, i32, ctypes.c_float,
        ctypes.POINTER(i32), ctypes.POINTER(i64), i32,
    ]


def _bind_rans(lib):
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rans_compress_bound.restype = ctypes.c_int64
    lib.rans_compress_bound.argtypes = [ctypes.c_uint32, ctypes.c_int]
    lib.rans_compress.restype = ctypes.c_int64
    lib.rans_compress.argtypes = [u8p, ctypes.c_uint32, ctypes.c_int, u8p]
    lib.rans_uncompress.restype = ctypes.c_int
    lib.rans_uncompress.argtypes = [u8p, ctypes.c_uint32, u8p,
                                    ctypes.c_uint32]


SPECS = {"align": (["align/align.cpp"], _bind_align),
         "vbz": (["vbz/vbz.cpp"], _bind_vbz),
         "mapper": (["mapper/mapper.cpp"], _bind_mapper),
         "ctcbeam": (["ctc/ctcbeam.cpp"], _bind_ctcbeam),
         "rans": (["rans/rans.cpp"], _bind_rans)}


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
