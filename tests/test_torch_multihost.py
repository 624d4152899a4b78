"""The port's multi-process sharding (parallel/multihost.py) on the CPU.

In one process: ``global_mesh`` over the process's devices, the rows its
shards own (``host_local_rows``), and the arrays and forcing that each
process builds for its own shards only (``make_global_array``,
``make_global_forcing``), as tests/test_multihost.py checks greb_tpu's.

Across two processes (as tests/test_multiprocess.py runs greb_tpu's): two
``torch.distributed`` processes on localhost over gloo each hold 2 of the
4 latitude shards of a 96x48 mesh, run the plain sharded spin-up and
scenario year on a 20-step calendar (the halos between shards 1 and 2
cross the process boundary by ``batch_isend_irecv``) and gather the rows;
process 0 holds the result bit for bit (max |diff| 0) against the same
years on a one-process mesh of 4 shards.  The worker is this file, run as
a script: ``python tests/test_torch_multihost.py <rank> <world> <port>``.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from greb_tpu_torch.io.synthetic import make_synthetic_forcing
from greb_tpu_torch.parallel import multihost as mh
from greb_tpu_torch.parallel import sharded as sh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_global_mesh_one_process():
    mesh = mh.global_mesh(n_ens=2, n_y=4, local_devices=["cpu"])
    assert mesh.shape == {"ens": 2, "y": 4}
    assert len(mesh.local()) == 8 and mesh.single_process()


def test_host_local_rows_cover_grid():
    mesh = mh.global_mesh(n_ens=1, n_y=4, local_devices=["cpu"])
    assert mh.host_local_rows(mesh, 48) == (0, 48)


def test_make_global_array_builds_each_shard_once():
    mesh = mh.global_mesh(n_ens=1, n_y=4, local_devices=["cpu"])
    data = np.arange(48 * 96, dtype=np.float32).reshape(48, 96)
    calls = []

    def fill(idx):
        calls.append(idx)
        return data[idx]

    arr = mh.make_global_array(mesh, ("y", None), data.shape, fill)
    assert len(calls) == 4 and sorted(arr) == mesh.local()
    np.testing.assert_array_equal(arr.gather().numpy(), data)


def test_make_global_forcing_specs():
    mesh = mh.global_mesh(n_ens=1, n_y=4, local_devices=["cpu"])
    arrs = make_synthetic_forcing(32, 16, 4, 2)
    g = mh.make_global_forcing(mesh, arrs)
    for k in ("tclim", "z_topo", "sw_solar"):
        np.testing.assert_array_equal(g[k].gather().numpy(), arrs[k])
    assert tuple(g["tclim"][(0, 1)].shape) == (4, 4, 32)
    assert tuple(g["sw_solar"][(0, 3)].shape) == (4, 4)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_processes_equal_one():
    port, world = _free_port(), 2
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         str(port)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=ROOT) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {r} failed:\n{out}"
    assert "MP_OK" in outs[0], outs[0]


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------
def run_years(mesh):
    """The plain sharded spin-up and scenario year of the 96x48 model on
    ``mesh``, gathered: (state after each, corrections, monthly means)."""
    from greb_tpu_torch.config import GrebConfig, Numerics
    from greb_tpu_torch.model.driver import GREB
    from greb_tpu_torch.ops import fastcirc2 as fc2
    num = Numerics(ndays_yr=10, jday_mon=(6, 4), time_flux=1, time_scnr=1)
    m = GREB(GrebConfig(numerics=num, fast_circulation=True), device="cpu",
             verbose=False)
    splan, sconst = fc2.build_sharded(None, None, m.grid, m.st, 0,
                                      mesh.n_y, fold=m.fold)
    fcc = sh.shard_fastcirc(mesh, sconst)
    flux, scnr = sh.make_sharded_year_runners(mesh, m.st, num, m.exp,
                                              m.month_mat, fast_plan=splan)
    st_s, sfx_s, _, md_s = sh.shard_inputs(mesh, False, m.initial_state(),
                                           m.sfx, None, m.md)
    co2 = np.float32(680.0)
    s1, c1 = flux(st_s, sfx_s, co2, md_s, fcc)
    s2, mon, _ = scnr(s1, sfx_s, c1, co2, md_s, fcc)
    return s1.gather(), c1.gather(), s2.gather(), mon.gather()


def _flat(res):
    s1, c1, s2, mon = res
    return ([s1.stack(), s2.stack(), mon]
            + [getattr(c1, f) for f in ("tf", "tof", "qf")])


def _worker(rank: int, world: int, port: int) -> None:
    torch.set_num_threads(1)
    mh.initialize(f"localhost:{port}", world, rank, backend="gloo")
    mesh = mh.global_mesh(n_ens=1, n_y=4, local_devices=["cpu"])
    assert mh.host_local_rows(mesh, 48) == (24 * rank, 24 * (rank + 1))
    got = run_years(mesh)
    if rank == 0:
        want = run_years(sh.make_mesh(1, 4, ["cpu"]))
        for a, b in zip(_flat(got), _flat(want)):
            assert torch.equal(a, b)
        assert torch.isfinite(got[2].ts).all()
        print("MP_OK: 2 processes x 2 shards equal 1 process x 4 shards")
    mh.shutdown()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
