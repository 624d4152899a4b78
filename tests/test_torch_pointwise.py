"""The port's pointwise physics against ``greb_tpu.ops.pointwise`` at 96x48.

Inputs: the synthetic forcing at one step plus a state drawn with numpy
from a seed, wide enough to cross every albedo, sea-ice and ocean ramp.
Both sides get the same float32 numbers; the port's params come across
through ``convert.params_from_numpy``.  Tolerance: rtol 1e-6, with an
absolute floor of 1e-6 of the field's scale where a difference of two
nearly equal terms (q - qs, dmld) makes a relative bound meaningless."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from greb_tpu.config import PhysicsParams as JParams
from greb_tpu.forcing import build_derived as j_build_derived
from greb_tpu.forcing import forcing_from_arrays as j_forcing
from greb_tpu.io.synthetic import make_synthetic_forcing
from greb_tpu.ops import pointwise as jpw

from greb_tpu_torch.convert import forcing_from_numpy, params_from_numpy
from greb_tpu_torch.forcing import build_derived
from greb_tpu_torch.ops import pointwise as pw

# The fields are small: one intra-op thread.  More threads only contend
# with the other test workers (measured ~7x slower under -n 6).
torch.set_num_threads(1)

RTOL = 1e-6
T = 200                      # a northern-summer step


def _close(got, want, name):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    atol = 1e-6 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def case():
    arrs = make_synthetic_forcing(96, 48, 730)
    jf = j_forcing(arrs)
    jp = JParams.default()
    leaves = {k: np.asarray(getattr(jp, k)) for k in jp.__dataclass_fields__}
    p = params_from_numpy(leaves)
    f = forcing_from_numpy({k: np.asarray(getattr(jf, k))
                            for k in jf.__dataclass_fields__}, "cpu")
    rng = np.random.default_rng(7)
    shape = (48, 96)
    state = dict(
        ts=rng.uniform(250.0, 285.0, shape).astype(np.float32),
        ta=rng.uniform(230.0, 300.0, shape).astype(np.float32),
        to=rng.uniform(268.0, 290.0, shape).astype(np.float32),
        q=rng.uniform(1e-4, 2e-2, shape).astype(np.float32),
        cap=rng.uniform(2e6, 4e8, shape).astype(np.float32))
    step = {k: arrs[k][T] for k in ("tclim", "qclim", "uclim", "vclim",
                                     "swetclim", "mldclim", "cldclim")}
    step["mld_prev"] = arrs["mldclim"][T - 1]
    step["sw_solar"] = arrs["sw_solar"][T]
    return dict(jp=jp, p=p, jd=j_build_derived(jp, jf), d=build_derived(p, f),
                arrs=arrs, state=state, step=step)


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.as_tensor(np.array(a))


def test_derived_constants(case):
    jd, d = case["jd"], case["d"]
    for k in ("wz_air", "wz_vapor", "z_ocean", "toclim"):
        _close(getattr(d, k), getattr(jd, k), k)
    for k in ("cap_ocean", "cap_land", "cap_air"):
        assert np.float32(getattr(d, k)) == np.float32(getattr(jd, k)), k


def test_shortwave(case):
    s, x, a = case["state"], case["step"], case["arrs"]
    want = jpw.shortwave(_j(s["ts"]), _j(x["cldclim"]), _j(x["sw_solar"]),
                         _j(a["z_topo"]), _j(a["glacier"]), case["jp"])
    got = pw.shortwave(_t(s["ts"]), _t(x["cldclim"]), _t(x["sw_solar"]),
                       _t(a["z_topo"]), _t(a["glacier"]), case["p"])
    for k in want._fields:
        _close(getattr(got, k), getattr(want, k), k)


def test_longwave(case):
    s, x, a = case["state"], case["step"], case["arrs"]
    wz = np.asarray(case["jd"].wz_air)
    co2 = np.float32(680.0)
    want = jpw.longwave(_j(s["ts"]), _j(s["ta"]), _j(s["q"]), co2,
                        _j(x["cldclim"]), _j(x["tclim"]), _j(x["qclim"]),
                        _j(a["z_topo"]), _j(wz), case["jp"])
    got = pw.longwave(_t(s["ts"]), _t(s["ta"]), _t(s["q"]), co2,
                      _t(x["cldclim"]), _t(x["tclim"]), _t(x["qclim"]),
                      _t(wz), case["p"])
    for k in want._fields:
        _close(getattr(got, k), getattr(want, k), k)


def test_sensible_heat(case):
    s = case["state"]
    _close(pw.sensible_heat(_t(s["ts"]), _t(s["ta"]), case["p"]),
           jpw.sensible_heat(_j(s["ts"]), _j(s["ta"]), case["jp"]), "q_sens")


def test_hydrology(case):
    s, x, a = case["state"], case["step"], case["arrs"]
    wz = np.asarray(case["jd"].wz_air)
    want = jpw.hydrology(_j(s["ts"]), _j(s["q"]), _j(x["uclim"]),
                         _j(x["vclim"]), _j(x["swetclim"]), _j(a["z_topo"]),
                         _j(wz), case["jp"])
    got = pw.hydrology(_t(s["ts"]), _t(s["q"]), _t(x["uclim"]),
                       _t(x["vclim"]), _t(x["swetclim"]), _t(a["z_topo"]),
                       _t(wz), case["p"])
    for k in want._fields:
        _close(getattr(got, k), getattr(want, k), k)


def test_seaice_capacity(case):
    s, x, a = case["state"], case["step"], case["arrs"]
    # ts around the To_ice1..To_ice2 ramp on the ocean points
    ts = np.float32(265.0) + (s["ts"] - np.float32(250.0)) / np.float32(3.0)
    want = jpw.seaice_capacity(_j(ts), _j(s["cap"]), _j(x["mldclim"]),
                               _j(a["z_topo"]), _j(a["glacier"]), case["jd"],
                               case["jp"])
    got = pw.seaice_capacity(_t(ts), _t(s["cap"]), _t(x["mldclim"]),
                             _t(a["z_topo"]), _t(a["glacier"]), case["d"],
                             case["p"])
    _close(got, want, "cap_surf")


def test_deep_ocean(case):
    s, x, a = case["state"], case["step"], case["arrs"]
    dt = np.float32(12 * 3600)
    want = jpw.deep_ocean(_j(s["ts"]), _j(s["to"]), _j(x["mldclim"]),
                          _j(x["mld_prev"]), _j(a["z_topo"]), dt, case["jd"],
                          case["jp"])
    got = pw.deep_ocean(_t(s["ts"]), _t(s["to"]), _t(x["mldclim"]),
                        _t(x["mld_prev"]), _t(a["z_topo"]), dt, case["d"],
                        case["p"])
    for k in want._fields:
        _close(getattr(got, k), getattr(want, k), k)
