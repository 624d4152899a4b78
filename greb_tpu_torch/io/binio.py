"""Binary record IO for the reference GREB file formats.

The reference uses Fortran DIRECT-ACCESS UNFORMATTED files: raw float32
records of RECL = 4*xdim*ydim bytes (lon varies fastest, then lat;
reference src/greb.f90:1018-1027 for inputs, :978-982 for outputs; layout
confirmed by the R reader R/functions.R:34-81).

NumPy arrays here are (ydim, xdim) [lat, lon] C-order, whose raw bytes match
the Fortran (xdim, ydim) column-major records exactly.

``read_records`` and ``write_records`` go through the native C++ library
built from native/recordio.cpp (pread/pwrite, GIL-free, multi-record
batching; io/native_recordio.py builds it at first use and raises if the
build fails), where greb_tpu uses it when present.  The NumPy loops stay as
``_read_records_numpy`` / ``_write_records_numpy``, the plain versions the
tests hold the native path to byte for byte.  ``OutputWriter`` writes
through a Python file, as greb_tpu's does.  One difference between the two
paths: a record past the end of the file raises OSError (EIO) natively,
EOFError in the NumPy loop.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

F32 = np.float32
_native = None


def _get_native():
    """The native library, built and loaded on first use."""
    global _native
    if _native is None:
        from .native_recordio import NativeRecordIO
        _native = NativeRecordIO.load()
    return _native


def _record_list(path: str, recl: int, records: Optional[Sequence[int]],
                 count: Optional[int]) -> list:
    """The 1-based records ``read_records`` reads."""
    if records is None:
        nrec_file = os.path.getsize(path) // recl
        n = nrec_file if count is None else min(count, nrec_file)
        records = range(1, n + 1)
    return list(records)


def read_records(path: str, shape: Sequence[int], records: Optional[Sequence[int]] = None,
                 count: Optional[int] = None) -> np.ndarray:
    """Read float32 records of the given per-record ``shape``.

    records: 1-based record indices (Fortran convention). If None, read
    ``count`` records from the start (or all records if count is None).
    Returns (nrec, *shape) float32.
    """
    recl = int(np.prod(shape)) * 4
    records = _record_list(path, recl, records, count)
    flat = _get_native().read(path, recl, [r - 1 for r in records])
    return flat.view(F32).reshape((len(records),) + tuple(shape))


def _read_records_numpy(path: str, shape: Sequence[int],
                        records: Optional[Sequence[int]] = None,
                        count: Optional[int] = None) -> np.ndarray:
    """``read_records`` through NumPy and Python file reads."""
    recl = int(np.prod(shape)) * 4
    records = _record_list(path, recl, records, count)
    out = np.empty((len(records),) + tuple(shape), F32)
    with open(path, "rb") as f:
        for i, r in enumerate(records):
            f.seek((r - 1) * recl)
            buf = f.read(recl)
            if len(buf) != recl:
                raise EOFError(f"{path}: record {r} truncated")
            out[i] = np.frombuffer(buf, F32).reshape(shape)
    return out


def write_records(path: str, data: np.ndarray, start_record: int = 1) -> None:
    """Write float32 records (nrec, *shape) at 1-based ``start_record``;
    records of an existing file past the written ones are kept."""
    data = np.ascontiguousarray(data, F32)
    recl = int(np.prod(data.shape[1:])) * 4
    _get_native().write(path, recl, start_record - 1, data)


def _write_records_numpy(path: str, data: np.ndarray,
                         start_record: int = 1) -> None:
    """``write_records`` through a Python file."""
    data = np.ascontiguousarray(data, F32)
    recl = int(np.prod(data.shape[1:])) * 4
    mode = "r+b" if os.path.exists(path) else "w+b"
    with open(path, mode) as f:
        f.seek((start_record - 1) * recl)
        f.write(data.tobytes())


class OutputWriter:
    """Streaming writer reproducing the reference's monthly output stream:
    per month, 5 sequential records (Tsurf, Tair, Tocean, q, albedo);
    reference src/greb.f90:978-982."""

    NVAR = 5
    VARS = ("tsurf", "tair", "tocean", "vapour", "albedo")

    def __init__(self, path: str, xdim: int, ydim: int, append: bool = False,
                 start_record: Optional[int] = None, truncate: bool = True):
        """``start_record`` (0-based record count) positions the stream.
        With ``truncate=True`` (crash-resume): records BEFORE it are kept,
        anything at or past it (months the resumed run will rewrite) is
        truncated away.  With ``truncate=False`` (Fortran direct-access
        semantics): the stream OVERWRITES from that record and leaves any
        tail records intact — the reference's control file keeps the
        TF_correct dump's tail after the control run rewinds to record 1
        (src/greb.original.model.f90:204-215).
        ``append=True`` keeps the whole file and continues at its end."""
        self.path = path
        self.xdim, self.ydim = xdim, ydim
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        recl = 4 * xdim * ydim
        if start_record is not None:
            exists = os.path.exists(path)
            have = os.path.getsize(path) if exists else 0
            if start_record > 0 and have < start_record * recl:
                # a resumed stream positioned past the end of the existing
                # file would silently zero-fill the head: the
                # pre-crash months are gone, refuse to fabricate them
                raise ValueError(
                    f"{path}: output resume expects >= {start_record} "
                    f"existing records ({start_record * recl} B), found "
                    f"{have} B — the file was truncated, moved or deleted; "
                    f"restart the run (or fix start_record)")
            self._f = open(path, "r+b" if exists else "w+b")
            if truncate:
                self._f.truncate(start_record * recl)
            self._f.seek(start_record * recl)
            self.irec = start_record
        else:
            self._f = open(path, "ab" if append else "wb")
            self.irec = (os.path.getsize(path) // recl
                         if append and os.path.exists(path) else 0)

    def write_months(self, monthly: np.ndarray) -> None:
        """monthly: (nmonths, 5, ydim, xdim) float32."""
        assert monthly.ndim == 4 and monthly.shape[1] == self.NVAR
        buf = np.ascontiguousarray(monthly, F32)
        self._f.write(buf.tobytes())
        self.irec += buf.shape[0] * self.NVAR

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_output(path: str, xdim: int = 96, ydim: int = 48, nvar: int = 5) -> np.ndarray:
    """Read a scenario/control output file -> (ntime, nvar, ydim, xdim).

    Python equivalent of the R reader ``read_greb`` (R/functions.R:34-81),
    including the exact file-size validation."""
    fsize = os.path.getsize(path)
    rec_bytes = 4 * xdim * ydim
    if fsize % (rec_bytes * nvar) != 0:
        raise ValueError(f"{path}: size {fsize} not a multiple of {nvar} records")
    ntime = fsize // (rec_bytes * nvar)
    raw = read_records(path, (ydim, xdim))
    return raw.reshape(ntime, nvar, ydim, xdim)
