"""ctypes binding to the native record-IO library (native/recordio.cpp),
``greb_tpu.io.native_recordio``'s counterpart.

``build`` compiles the package's own ``native/recordio.cpp`` at first use
with the flags of greb_tpu/native/Makefile (``g++ -O3 -fPIC -std=c++17
-Wall -shared -lpthread``) into ``greb_tpu_torch/_build/librecordio.so``,
and again when the source is newer than the library.  The compiler writes
to a temporary name in that directory, renamed into place when it
succeeds, so processes that build at the same moment never load a partial
library.  A build that fails raises with the compiler's output: nothing
falls back to the NumPy path (``NativeRecordIO.load`` replaces
greb_tpu's ``try_load``, which returns None when the library is absent).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Sequence

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(PKG_DIR, "native", "recordio.cpp")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
LIB_NAME = "librecordio.so"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall")
LD_FLAGS = ("-shared", "-lpthread")


def build(cxx: str = "g++", build_dir: str = BUILD_DIR) -> str:
    """The path of the library in ``build_dir``, compiled by ``cxx`` from
    ``SOURCE`` unless a library newer than the source is there.  Raises
    RuntimeError with the compiler's output when it fails or cannot run."""
    lib = os.path.join(build_dir, LIB_NAME)
    if (os.path.exists(lib)
            and os.path.getmtime(lib) >= os.path.getmtime(SOURCE)):
        return lib
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=build_dir, prefix=LIB_NAME + ".",
                               suffix=".tmp")
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, SOURCE, "-o", tmp, *LD_FLAGS]
    try:
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"native record IO: cannot run {cxx!r}: {e}")
        if res.returncode != 0:
            raise RuntimeError(
                f"native record IO: {' '.join(cmd)} exited "
                f"{res.returncode}:\n{res.stdout}{res.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


class NativeRecordIO:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.greb_read_records.restype = ctypes.c_int
        lib.greb_read_records.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        lib.greb_write_records.restype = ctypes.c_int
        lib.greb_write_records.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.greb_file_records.restype = ctypes.c_int64
        lib.greb_file_records.argtypes = [ctypes.c_char_p, ctypes.c_int64]

    @classmethod
    def load(cls, cxx: str = "g++", build_dir: str = BUILD_DIR
             ) -> "NativeRecordIO":
        """The library built by ``build(cxx, build_dir)``, loaded."""
        return cls(ctypes.CDLL(build(cxx, build_dir)))

    def read(self, path: str, recl: int, indices: Sequence[int],
             nthreads: int = 4) -> np.ndarray:
        idx = np.asarray(list(indices), dtype=np.int64)
        out = np.empty(len(idx) * recl, dtype=np.uint8)
        rc = self._lib.greb_read_records(
            path.encode(), recl,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), nthreads)
        if rc != 0:
            raise OSError(-rc, os.strerror(-rc), path)
        return out

    def write(self, path: str, recl: int, start: int, data: np.ndarray) -> None:
        buf = np.ascontiguousarray(data).view(np.uint8).ravel()
        nrec = buf.size // recl
        rc = self._lib.greb_write_records(
            path.encode(), recl, start,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), nrec)
        if rc != 0:
            raise OSError(-rc, os.strerror(-rc), path)

    def n_records(self, path: str, recl: int) -> int:
        n = self._lib.greb_file_records(path.encode(), recl)
        if n < 0:
            raise OSError(int(-n), os.strerror(int(-n)), path)
        return int(n)
