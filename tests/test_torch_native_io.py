"""The port's native record IO (greb_tpu_torch/native/recordio.cpp through
io/native_recordio.py) against its NumPy loops and against greb_tpu.

* The library builds from the package's own source into
  ``greb_tpu_torch/_build/``, and again when the source is newer.
* ``read_records`` / ``write_records`` (native) and
  ``_read_records_numpy`` / ``_write_records_numpy`` give byte-equal
  arrays and files: out-of-order subsets, ``count``, a write into a longer
  file (its tail kept), ``n_records``.
* Each path reads and writes what ``greb_tpu.io.binio`` does on the same
  file.
* A build that fails raises with the compiler's output; nothing falls back
  to NumPy (greb_tpu's ``try_load`` returns None instead).
"""
import os
import stat

import numpy as np
import pytest

from greb_tpu.io import binio as jbinio

from greb_tpu_torch.io import binio
from greb_tpu_torch.io import native_recordio as nrio

F32 = np.float32
SHAPE = (24, 48)
RECL = SHAPE[0] * SHAPE[1] * 4


def _records(n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n,) + SHAPE).astype(F32)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_library_builds_from_the_package_source(tmp_path):
    lib = nrio.build()
    assert lib == os.path.join(nrio.PKG_DIR, "_build", "librecordio.so")
    assert os.path.getmtime(lib) >= os.path.getmtime(nrio.SOURCE)
    assert nrio.SOURCE == os.path.join(nrio.PKG_DIR, "native", "recordio.cpp")
    # a build directory of its own: built, reused, rebuilt once the source
    # is newer than the library
    mine = nrio.build(build_dir=str(tmp_path))
    assert mine == str(tmp_path / "librecordio.so")
    built = os.path.getmtime(mine)
    assert nrio.build(build_dir=str(tmp_path)) == mine
    assert os.path.getmtime(mine) == built
    src = os.path.getmtime(nrio.SOURCE)
    os.utime(mine, (src - 100, src - 100))
    nrio.build(build_dir=str(tmp_path))
    assert os.path.getmtime(mine) >= src
    assert sorted(os.listdir(tmp_path)) == ["librecordio.so"]
    nat = nrio.NativeRecordIO.load(build_dir=str(tmp_path))
    p = str(tmp_path / "recs")
    nat.write(p, RECL, 0, _records(3))
    assert nat.n_records(p, RECL) == 3


@pytest.mark.parametrize("records,count", [
    (None, None), ([3, 1, 5], None), ([7, 7, 2, 10], None), (None, 4),
    (None, 99), ([], None)])
def test_native_read_equals_numpy(tmp_path, records, count):
    p = str(tmp_path / "recs")
    binio._write_records_numpy(p, _records(10))
    got = binio.read_records(p, SHAPE, records=records, count=count)
    want = binio._read_records_numpy(p, SHAPE, records=records, count=count)
    assert got.dtype == want.dtype == F32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    # and greb_tpu's reader on the same file
    assert jbinio.read_records(p, SHAPE, records=records,
                               count=count).tobytes() == got.tobytes()


@pytest.mark.parametrize("start", [1, 4, 8, 11])
def test_native_write_equals_numpy_and_keeps_the_tail(tmp_path, start):
    """Three records written at ``start`` into a file of ten: the records
    before and after them are kept (and a write past the end extends the
    file); native, NumPy and greb_tpu's files are byte-equal."""
    old, new = _records(10, seed=1), _records(3, seed=2)
    files = {}
    for name, write in (("native", binio.write_records),
                        ("numpy", binio._write_records_numpy),
                        ("greb_tpu", jbinio.write_records)):
        p = str(tmp_path / name)
        binio._write_records_numpy(p, old)
        write(p, new, start_record=start)
        files[name] = _bytes(p)
    assert files["native"] == files["numpy"] == files["greb_tpu"]
    got = np.frombuffer(files["native"], F32).reshape((-1,) + SHAPE)
    assert len(got) == max(10, start + 2)
    np.testing.assert_array_equal(got[start - 1:start + 2], new)
    np.testing.assert_array_equal(got[:start - 1], old[:start - 1])
    np.testing.assert_array_equal(got[start + 2:10], old[start + 2:])


def test_new_file_and_n_records(tmp_path):
    data = _records(6)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    binio.write_records(a, data)
    binio._write_records_numpy(b, data)
    assert _bytes(a) == _bytes(b) == data.tobytes()
    nat = binio._get_native()
    assert isinstance(nat, nrio.NativeRecordIO)
    assert nat.n_records(a, RECL) == 6 == os.path.getsize(b) // RECL
    with pytest.raises(FileNotFoundError):
        nat.n_records(str(tmp_path / "none"), RECL)
    # a record past the end: OSError natively, EOFError in the NumPy loop
    with pytest.raises(OSError):
        binio.read_records(a, SHAPE, records=[7])
    with pytest.raises(EOFError):
        binio._read_records_numpy(a, SHAPE, records=[7])


def test_read_output_through_native_equals_greb_tpu(tmp_path):
    """The output stream the port's OutputWriter writes reads back through
    the native library as through greb_tpu's reader."""
    from greb_tpu_torch.io.binio import OutputWriter, read_output
    months = np.random.default_rng(3).uniform(
        200, 300, (4, 5) + SHAPE).astype(F32)
    p = str(tmp_path / "scenario")
    with OutputWriter(p, SHAPE[1], SHAPE[0]) as w:
        w.write_months(months)
    got = read_output(p, SHAPE[1], SHAPE[0])
    assert got.tobytes() == months.tobytes()
    assert jbinio.read_output(p, SHAPE[1], SHAPE[0]).tobytes() == \
        got.tobytes()


def _broken_compiler(tmp_path):
    cxx = tmp_path / "broken-cxx"
    cxx.write_text("#!/bin/sh\necho 'broken-cxx: cannot compile' >&2\n"
                   "exit 3\n")
    cxx.chmod(cxx.stat().st_mode | stat.S_IXUSR)
    return str(cxx)


def test_a_failed_build_raises_with_the_compilers_output(tmp_path):
    out = tmp_path / "build"
    cxx = _broken_compiler(tmp_path)
    with pytest.raises(RuntimeError, match="broken-cxx: cannot compile"):
        nrio.build(cxx=cxx, build_dir=str(out))
    with pytest.raises(RuntimeError, match="exited 3"):
        nrio.NativeRecordIO.load(cxx=cxx, build_dir=str(out))
    with pytest.raises(RuntimeError, match="cannot run"):
        nrio.build(cxx=str(tmp_path / "no-such-cxx"), build_dir=str(out))
    # nothing built, no temporary file left behind
    assert os.listdir(out) == []
