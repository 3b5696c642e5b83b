"""LMDB access dispatcher: C++ native reader (ctypes) with pure-Python
fallback. Both are from-scratch implementations of the mdb format (no
liblmdb needed); they are cross-validated against each other in tests, plus
against fixture files produced by the independent writer.

The port's copy of the JAX package's ``native/lmdb.py``, with the same
choice of reader: the native ``.so`` when g++ builds it, else the
pure-Python reader (host code; ``open`` returns either, and the returned
object's ``backend`` says which). The ``.so`` is built at first use from
``native/src/lmdb_reader.cc`` into ``build/unimm_torch/`` at the root of the
checkout (the kernels' build directory), never next to its source.

Set UNIMM_LMDB_BACKEND=python|native to force a backend.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import Iterator, Optional, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "lmdb_reader.cc")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                      "unimm_torch")
_SO = os.path.join(_BUILD, "_lmdb_reader.so")


def _build_native() -> Optional[str]:
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    try:
        os.makedirs(_BUILD, exist_ok=True)
        # a private name, then a rename: processes building at once never
        # race
        tmp = f"{_SO}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp],
            check=True, capture_output=True)
        os.replace(tmp, _SO)
        return _SO
    except Exception as e:  # no compiler / sandboxed build failure
        print(f"[unimm_torch.native.lmdb] native build unavailable: {e}",
              file=sys.stderr)
        return None


class _NativeDB:
    backend = "native"

    def __init__(self, path: str):
        so = _build_native()
        if so is None:
            raise RuntimeError("native backend unavailable")
        lib = ctypes.CDLL(so)
        lib.mdbr_open.restype = ctypes.c_void_p
        lib.mdbr_open.argtypes = [ctypes.c_char_p]
        lib.mdbr_entries.restype = ctypes.c_int64
        lib.mdbr_entries.argtypes = [ctypes.c_void_p]
        lib.mdbr_get.restype = ctypes.c_int
        lib.mdbr_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint64)]
        lib.mdbr_iter_begin.restype = ctypes.c_int
        lib.mdbr_iter_begin.argtypes = [ctypes.c_void_p]
        lib.mdbr_iter_next.restype = ctypes.c_int
        lib.mdbr_iter_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint64)]
        lib.mdbr_close.argtypes = [ctypes.c_void_p]
        self._lib = lib
        self._h = lib.mdbr_open(path.encode())
        if not self._h:
            raise ValueError(f"cannot open LMDB file: {path}")

    @property
    def entries(self) -> int:
        return self._lib.mdbr_entries(self._h)

    def get(self, key: bytes) -> Optional[bytes]:
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_uint64()
        found = self._lib.mdbr_get(self._h, key, len(key),
                                   ctypes.byref(out), ctypes.byref(out_len))
        if not found:
            return None
        return ctypes.string_at(out, out_len.value)

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        self._lib.mdbr_iter_begin(self._h)
        k = ctypes.POINTER(ctypes.c_uint8)()
        v = ctypes.POINTER(ctypes.c_uint8)()
        klen = ctypes.c_uint64()
        vlen = ctypes.c_uint64()
        while self._lib.mdbr_iter_next(self._h, ctypes.byref(k),
                                       ctypes.byref(klen), ctypes.byref(v),
                                       ctypes.byref(vlen)):
            yield (ctypes.string_at(k, klen.value),
                   ctypes.string_at(v, vlen.value))

    def close(self):
        if self._h:
            self._lib.mdbr_close(self._h)
            self._h = None


class _PythonDB:
    backend = "python"

    def __init__(self, path: str):
        from unimm_torch.native.lmdb_format import Reader
        self._r = Reader(path)

    @property
    def entries(self) -> int:
        return self._r.entries

    def get(self, key: bytes) -> Optional[bytes]:
        return self._r.get(key)

    def items(self):
        return self._r.items()

    def close(self):
        self._r.close()


def open(path: str):  # noqa: A001 (mirrors lmdb.open)
    backend = os.environ.get("UNIMM_LMDB_BACKEND", "")
    if backend == "python":
        return _PythonDB(path)
    if backend == "native":
        return _NativeDB(path)
    try:
        return _NativeDB(path)
    except Exception:
        return _PythonDB(path)
