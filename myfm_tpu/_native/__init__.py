"""ctypes loader for the native planner (see planner.cc).

Builds the shared library lazily with the system C++ compiler on first
import (single translation unit, no third-party deps) and caches the
binary next to the source.  Exposes ``greedy_color_native`` — or
``None`` when no compiler/binary is available, in which case
``myfm_tpu.design`` falls back to the pure-numpy implementation.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sysconfig

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "planner.cc")
_EXT = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
_LIB = os.path.join(_HERE, "_planner" + _EXT)


def _build() -> bool:
    for cxx in (os.environ.get("CXX"), "g++", "clang++", "c++"):
        if not cxx:
            continue
        cmd = [cxx, "-O3", "-std=c++14", "-shared", "-fPIC", _SRC,
               "-o", _LIB]
        try:
            res = subprocess.run(
                cmd, capture_output=True, timeout=120
            )
        except (OSError, subprocess.TimeoutExpired):
            continue
        if res.returncode == 0 and os.path.exists(_LIB):
            return True
    return False


def _load():
    if not os.path.exists(_LIB) or (
        os.path.exists(_SRC)
        and os.path.getmtime(_SRC) > os.path.getmtime(_LIB)
    ):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_LIB)
    except OSError:
        return None
    i64 = ctypes.c_int64
    p64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")

    fn = lib.myfm_greedy_color
    fn.restype = None
    fn.argtypes = [i64, i64, p64, p32, p32]

    pr = lib.myfm_packed_rows
    pr.restype = i64
    pr.argtypes = [i64, p64, i64, i64]

    pt = lib.myfm_pack_tiles
    pt.restype = None
    pt.argtypes = [i64, i64, p64, p64, i64, i64, i64, p32, p32, p32, p32]
    return fn, pr, pt


_fns = _load()

if _fns is None:  # pragma: no cover - depends on toolchain availability
    greedy_color_native = None
    packed_rows_native = None
    pack_tiles_native = None
else:
    _fn, _pr, _pt = _fns

    def greedy_color_native(
        n_rows: int, n_cols: int, indptr, indices
    ) -> np.ndarray:
        """C++ greedy coloring; signature mirrors the numpy fallback in
        myfm_tpu.design.greedy_color."""
        indptr = np.ascontiguousarray(indptr, dtype=np.int64)
        indices = np.ascontiguousarray(indices, dtype=np.int32)
        assign = np.zeros(n_cols, dtype=np.int32)
        _fn(n_rows, n_cols, indptr, indices, assign)
        return assign

    def packed_rows_native(counts, T: int, S: int) -> int:
        counts = np.ascontiguousarray(counts, dtype=np.int64)
        return int(_pr(len(counts), counts, T, S))

    def pack_tiles_native(order, counts, n: int, T: int, S: int):
        """C++ greedy tile packing (design_categorical._pack_tiles);
        returns the same (src, slot, ent, ent_slots) tuple as the
        Python implementation, with one trailing all-pad tile already
        appended."""
        order = np.ascontiguousarray(order, dtype=np.int64)
        counts = np.ascontiguousarray(counts, dtype=np.int64)
        n_entities = len(counts)
        n_out = int(_pr(n_entities, counts, T, S)) + T
        K = n_out // T
        src = np.empty(n_out, dtype=np.int32)
        slot = np.empty(n_out, dtype=np.int32)
        ent = np.empty(n_out, dtype=np.int32)
        ent_slots = np.empty(K * S, dtype=np.int32)
        _pt(n, n_entities, order, counts, T, S, n_out, src, slot, ent,
            ent_slots)
        return src, slot, ent, ent_slots.reshape(K, S)
