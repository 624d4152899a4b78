"""The port's ``regrid.py`` against ``greb_tpu.regrid`` on the synthetic
96x48 forcing: onto 384x192 and 192x96 and back, bit for bit (both are
NumPy on the host with the same float32 blending), every array finite.
The one intended difference: an integer field regrids as its float32 copy
(the JAX package casts the weights to the field's dtype, which for an
integer field rounds them to 0 or 1).
"""
import numpy as np
import pytest

from greb_tpu import regrid as jrg
from greb_tpu.config import Numerics as JNumerics

from greb_tpu_torch import regrid as rg
from greb_tpu_torch.config import Numerics
from greb_tpu_torch.forcing import ClimForcing, forcing_from_arrays
from greb_tpu_torch.io.synthetic import make_synthetic_forcing

# 4 steps of the 2-day calendar: every field of the forcing, small
STEPS, DAYS = 4, 2
GRIDS = [(384, 192), (192, 96), (96, 48)]


@pytest.fixture(scope="module")
def arrs():
    return make_synthetic_forcing(96, 48, STEPS, DAYS)


def _same(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all(), f"{name}: not finite"
    assert got.dtype == want.dtype == np.float32, name
    np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("xy", GRIDS, ids=[f"{x}x{y}" for x, y in GRIDS])
@pytest.mark.parametrize("nearest", [False, True], ids=["bilinear", "nearest"])
def test_regrid_field_matches(arrs, xy, nearest):
    x, y = xy
    for key in ("tclim", "z_topo", "uclim"):
        _same(rg.regrid_field(arrs[key], x, y, nearest),
              jrg.regrid_field(arrs[key], x, y, nearest), f"{key} {xy}")


@pytest.mark.parametrize("xy", GRIDS[:2], ids=["384x192", "192x96"])
def test_regrid_there_and_back(arrs, xy):
    """Onto the refined grid, then back onto 96x48 by interpolation and by
    the area-weighted box average."""
    x, y = xy
    up = rg.regrid_field(arrs["tclim"], x, y)
    _same(rg.regrid_field(up, 96, 48), jrg.regrid_field(up, 96, 48),
          "back, bilinear")
    _same(rg.coarsen_field(up, 96, 48), jrg.coarsen_field(up, 96, 48),
          "back, coarsened")
    # the box average of a bilinear refinement stays near the source: within
    # 3 K (2.89 K measured, on the pole rows, where the refinement clamps)
    np.testing.assert_allclose(rg.coarsen_field(up, 96, 48), arrs["tclim"],
                               atol=3.0)


def test_coarsen_refuses_grids_that_do_not_nest(arrs):
    with pytest.raises(ValueError, match="does not coarsen"):
        rg.coarsen_field(arrs["tclim"], 80, 48)


@pytest.mark.parametrize("y", [192, 96, 48])
def test_regrid_solar_matches(arrs, y):
    _same(rg.regrid_solar(arrs["sw_solar"], y),
          jrg.regrid_solar(arrs["sw_solar"], y), f"sw_solar {y}")


@pytest.mark.parametrize("xy", GRIDS[:2], ids=["384x192", "192x96"])
def test_regrid_forcing_arrays_matches(arrs, xy):
    x, y = xy
    num = Numerics(xdim=x, ydim=y, ndays_yr=DAYS, jday_mon=(DAYS,))
    jnum = JNumerics(xdim=x, ydim=y, ndays_yr=DAYS, jday_mon=(DAYS,))
    got = rg.regrid_forcing_arrays(arrs, num)
    want = jrg.regrid_forcing_arrays(arrs, jnum)
    assert sorted(got) == sorted(want) == sorted(arrs)
    for key in got:
        _same(got[key], want[key], key)
    # the ocean marker and the glacier mask survive
    assert set(np.unique(got["glacier"])) <= {0.0, 1.0}
    assert (got["z_topo"][got["z_topo"] < 0] == np.float32(-0.1)).all()


def test_regrid_forcing_builds_contiguous_tensors(arrs):
    num = Numerics(xdim=384, ydim=192, ndays_yr=DAYS, jday_mon=(DAYS,))
    forcing = rg.regrid_forcing(forcing_from_arrays(arrs, "cpu"), num)
    want = rg.regrid_forcing_arrays(arrs, num)
    for key in ClimForcing.__dataclass_fields__:
        ten = getattr(forcing, key)
        assert ten.is_contiguous() and str(ten.device) == "cpu", key
        _same(ten.numpy(), want[key], key)


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.int16])
def test_integer_field_regrids_as_its_float32_copy(arrs, dtype):
    field = np.round(arrs["tclim"][0]).astype(dtype)
    got = rg.regrid_field(field, 384, 192)
    want = rg.regrid_field(field.astype(np.float32), 384, 192)
    _same(got, want, f"{np.dtype(dtype).name} field")
    # the JAX package's copy rounds the weights to 0/1 for such a field
    assert not np.array_equal(jrg.regrid_field(field, 384, 192), want)
