"""Build and load the package's CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for Hopper (sm_90a) into a
shared library with a plain C interface, loaded with ctypes.  The build
goes into ``greb_tpu_torch/_build/`` (git-ignored) at first use, one
library per source named by the hash of the source, so an edited source is
rebuilt and an unchanged one is reused.  All sources compile at once, one
``nvcc`` each.  Numerics: no ``--use_fast_math``, and ``--fmad=false`` so
no multiply and add are fused into one rounding (see csrc/year_kernel.cu).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
# the year kernels' cluster body, their refined instantiation, the refined
# forms of the grids between 192x96 and 384x192, the strict form's wide
# variant at 768x384, the member kernels' matmul circulation and the
# sharded runners' slab kernels (all built on the year kernels' device
# functions, each a library of its own so that they compile at once), and
# a probe of the cluster barrier's cost that chip_smoke.py reads beside
# them
SOURCES = ("year_kernel", "refined_kernel", "band_kernel",
           "strict_wide_kernel", "members_kernel", "slab_kernel",
           "cluster_probe")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> str:
    """The library of ``csrc/<name>.cu``, named by the hash of the source
    and of the sources it includes from ``csrc/`` (``#include "..."``)."""
    h = hashlib.sha256()
    todo, seen = [name + ".cu"], set()
    while todo:
        src = todo.pop(0)
        if src in seen:
            continue
        seen.add(src)
        with open(os.path.join(SRC_DIR, src), "rb") as f:
            text = f.read()
        h.update(text)
        todo += re.findall(rb'^#include "([^"]+)"', text, re.M)
        todo = [t.decode() if isinstance(t, bytes) else t for t in todo]
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all() -> Dict[str, float]:
    """Compile every source that has no current library, all at once.
    Returns {source: seconds until its compiler ended}; the compiler's
    register/shared-memory report goes to ``_build/<source>.ptxas.txt``."""
    todo = [n for n in SOURCES if not os.path.exists(_lib_path(n))]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = _lib_path(name) + f".{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(SRC_DIR, name + ".cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    # each source's own time: its compiler's output read in a thread of
    # its own, the time taken as that compiler ends
    times, outs, failed = {}, {}, []

    def drain(name, proc):
        outs[name] = proc.communicate()[0]
        times[name] = time.perf_counter() - t0

    readers = [threading.Thread(target=drain, args=(name, proc))
               for name, (_, proc) in procs.items()]
    for r in readers:
        r.start()
    for r in readers:
        r.join()
    for name, (tmp, proc) in procs.items():
        with open(os.path.join(BUILD_DIR, name + ".ptxas.txt"), "w") as f:
            f.write(outs[name])
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{outs[name]}")
            continue
        os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _libs:
        build_all()
        _libs[name] = ctypes.CDLL(_lib_path(name))
    return _libs[name]
