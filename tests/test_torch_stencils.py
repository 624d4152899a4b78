"""The port's strict stencils (``greb_tpu_torch.ops.stencils``, the plain
version of the year kernels' strict mode) against ``greb_tpu.ops.stencils``
and the NumPy oracle, on the CPU.

Same grid metrics and the same numpy inputs, made from a seed (Ta- and
q-like fields, wz, winds of the synthetic forcing), go through both:
``diffusion`` (Ta with wz_air, q with wz_vapor), ``advection`` at two steps
of the year, ``circulation`` at 1 and 24 substeps, with and without
advection (legacy log_exp 8) and with the jp2 quirk on and off, the
batched (2, Y, X) form against the two fields run separately, at 96x48
and 48x24, and one substep on an extension-mode grid (384x192, the
sequential ``seq_zonal`` branch).

Tolerance (on an increment, as tests/test_torch_fold.py states it): rtol
1e-5, and atol 1e-6 of the field's magnitude.  The increment is
(x + dx) - x, so its rounding is a few ulps of x, not of dx; XLA on the
CPU may fuse a multiply and an add into one rounding where PyTorch rounds
twice, which moves x + dx by 1-4 ulps a substep.  Against the oracle the
tolerances of tests/test_stencils.py hold (rtol 3e-5, atol 1e-7).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from greb_tpu.grid import make_grid as j_make_grid
from greb_tpu.io.synthetic import make_synthetic_forcing
from greb_tpu.ops import stencils as jst

from greb_tpu_torch.grid import make_grid
from greb_tpu_torch.ops import stencils as st

# The fields are small: one intra-op thread.  More threads only contend
# with the other test workers (measured ~7x slower under -n 6).
torch.set_num_threads(1)

SEED = 20261017
KAPPA = np.float32(8e5)
GRIDS = {"96x48": (96, 48), "48x24": (48, 24)}


class Case:
    """The inputs of one grid, drawn from the seed, on both sides, and the
    grid's stencil arrays with the jp2 quirk (``quirk``) and without."""

    def __init__(self, xdim, ydim, steps=(0, 400)):
        rng = np.random.default_rng(SEED)
        shape = (ydim, xdim)
        f32 = lambda a: np.asarray(a, np.float32)
        self.x = {"ta": f32(250.0 + 40.0 * rng.random(shape)),
                  "q": f32(1e-3 + 1.5e-2 * rng.random(shape))}
        self.wz = {"ta": f32(np.exp(-0.5 * rng.random(shape))),
                   "q": f32(np.exp(-2.0 * rng.random(shape)))}
        # a 730-step year, or a 1-day one where only step 0 is used
        forcing = (make_synthetic_forcing(xdim, ydim, 730) if max(steps)
                   else make_synthetic_forcing(xdim, ydim, 2, 1))
        self.winds = {t: (f32(forcing["uclim"][t]), f32(forcing["vclim"][t]))
                      for t in steps}
        self.arrays = {}
        for quirk in (True, False):
            js, jsf = jst.make_stencil_arrays(j_make_grid(xdim, ydim, 1800),
                                              quirk)
            self.arrays[quirk] = (
                js, type(jsf)(**{k: jnp.asarray(v)
                                 for k, v in vars(jsf).items()}),
                *st.make_stencil_arrays(make_grid(xdim, ydim, 1800), quirk))
        self.jst, self.jsf, self.st, self.sf = self.arrays[True]

    def jwinds(self, t):
        u, v = (jnp.asarray(a) for a in self.winds[t])
        return (jnp.maximum(u, 0.0), jnp.minimum(u, 0.0),
                jnp.maximum(v, 0.0), jnp.minimum(v, 0.0))

    def pwinds(self, t):
        u, v = (torch.as_tensor(a) for a in self.winds[t])
        return (u.clamp(min=0.0), u.clamp(max=0.0), v.clamp(min=0.0),
                v.clamp(max=0.0))


@pytest.fixture(scope="module", params=list(GRIDS), ids=list(GRIDS))
def case(request):
    return Case(*GRIDS[request.param])


def _close(got, want, x, name):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                               atol=1e-6 * float(np.abs(x).max()),
                               err_msg=name)


def test_stencil_arrays_match(case):
    assert case.st == st.StencilStatic(**vars(case.jst))
    for k, v in vars(case.sf).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(
            getattr(case.jsf, k)), err_msg=k)


@pytest.mark.parametrize("field", ["ta", "q"])
def test_diffusion(case, field):
    x, wz = case.x[field], case.wz[field]
    jpack = jst.make_wz_pack(jnp.asarray(wz), case.jst, jst.extend_lat_zero)
    want = jst.diffusion(jnp.asarray(x), jnp.asarray(wz), jpack, case.jst,
                         case.jsf, KAPPA)
    tw = torch.as_tensor(wz)
    got = st.diffusion(torch.as_tensor(x), tw, st.make_wz_pack(tw, case.st),
                       case.st, case.sf, KAPPA)
    _close(got, want, x, f"diffusion[{field}]")


@pytest.mark.parametrize("ityr", [0, 400])
@pytest.mark.parametrize("field", ["ta", "q"])
def test_advection(case, field, ityr):
    x, wz = case.x[field], case.wz[field]
    jpack = jst.make_wz_pack(jnp.asarray(wz), case.jst, jst.extend_lat_zero)
    want = jst.advection(jnp.asarray(x), jpack, *case.jwinds(ityr),
                         case.jst, case.jsf)
    tw = torch.as_tensor(wz)
    got = st.advection(torch.as_tensor(x), st.make_wz_pack(tw, case.st),
                       *case.pwinds(ityr), case.st, case.sf)
    _close(got, want, x, f"advection[{field}]")


@pytest.mark.parametrize("quirk", [True, False], ids=["quirk", "no-quirk"])
@pytest.mark.parametrize("advect", [True, False], ids=["adv", "diff-only"])
@pytest.mark.parametrize("nsub", [1, 24])
def test_circulation(case, nsub, advect, quirk):
    """(Ta, q) batched, as the step runs them."""
    js, jsf, ps, psf = case.arrays[quirk]
    x2 = np.stack([case.x["ta"], case.x["q"]])
    wz2 = np.stack([case.wz["ta"], case.wz["q"]])
    want = jst.circulation(jnp.asarray(x2), jnp.asarray(wz2),
                           *case.jwinds(0), js, jsf, KAPPA, nsub,
                           include_advection=advect)
    got = st.circulation(torch.as_tensor(x2), torch.as_tensor(wz2),
                         *case.pwinds(0), ps, psf, KAPPA, nsub,
                         include_advection=advect)
    for i, field in enumerate(("ta", "q")):
        _close(got[i], np.asarray(want)[i], x2[i], f"circulation[{field}]")


def test_batched_equals_separate(case):
    """(Ta, q) batched along a leading axis, as the step runs them, equal
    to the two fields run separately, bit for bit: every operation is
    elementwise or row-local."""
    winds = case.pwinds(400)
    t = {f: torch.as_tensor(case.x[f]) for f in ("ta", "q")}
    w = {f: torch.as_tensor(case.wz[f]) for f in ("ta", "q")}
    both = st.circulation(torch.stack([t["ta"], t["q"]]),
                          torch.stack([w["ta"], w["q"]]), *winds, case.st,
                          case.sf, KAPPA, 24)
    for i, f in enumerate(("ta", "q")):
        sep = st.circulation(t[f], w[f], *winds, case.st, case.sf, KAPPA, 24)
        assert torch.equal(both[i], sep), f


def test_masked_form_equals_compact_form(case):
    """The masked full-field form (compact_polar False, the form of a
    non-contiguous polar set) gives the compact form's values bit for
    bit: the zonal stencils are row-local."""
    masked = st.StencilStatic(**{**vars(case.st), "compact_polar": False,
                                 "polar_top": 0, "polar_bot": 0})
    x, wz = torch.as_tensor(case.x["ta"]), torch.as_tensor(case.wz["ta"])
    winds = case.pwinds(0)
    a = st.circulation(x, wz, *winds, case.st, case.sf, KAPPA, 2)
    b = st.circulation(x, wz, *winds, masked, case.sf, KAPPA, 2)
    assert torch.equal(a, b)


def test_extension_grid_substep():
    """One substep at 384x192, an extension-mode grid: the sequential
    zonal splitting (seq_zonal) and the deep polar sub-cycles."""
    c = Case(384, 192, steps=(0,))
    assert c.st.seq_zonal and c.st.diff_max_iter > 16
    x2 = np.stack([c.x["ta"], c.x["q"]])
    wz2 = np.stack([c.wz["ta"], c.wz["q"]])
    want = np.asarray(jst.circulation(jnp.asarray(x2), jnp.asarray(wz2),
                                      *c.jwinds(0), c.jst, c.jsf, KAPPA, 1))
    got = st.circulation(torch.as_tensor(x2), torch.as_tensor(wz2),
                         *c.pwinds(0), c.st, c.sf, KAPPA, 1)
    for i, field in enumerate(("ta", "q")):
        _close(got[i], want[i], x2[i], f"extension substep[{field}]")


@pytest.mark.parametrize("field,wzname", [("ta", "wz_air"),
                                          ("q", "wz_vapor")])
def test_against_the_oracle(setup, field, wzname):
    """Diffusion and advection (step 400) against the NumPy oracle's
    literal transliteration of src/greb.f90, at tests/test_stencils.py's
    tolerances, on its 96x48 initial state."""
    o = setup.oracle
    x, wz = o.initial_state()[field], getattr(o, wzname)
    s, sf = st.make_stencil_arrays(make_grid(96, 48, 1800))
    tx, tw = torch.as_tensor(x), torch.as_tensor(wz)
    pack = st.make_wz_pack(tw, s)
    got = st.diffusion(tx, tw, pack, s, sf, setup.params.kappa)
    np.testing.assert_allclose(got.numpy(), o.diffusion(x, wz), rtol=3e-5,
                               atol=1e-7, err_msg=f"diffusion[{field}]")
    winds = (torch.as_tensor(a[400]) for a in (o.uclim_m, o.uclim_p,
                                               o.vclim_m, o.vclim_p))
    got = st.advection(tx, pack, *winds, s, sf)
    np.testing.assert_allclose(got.numpy(), o.advection(x, wz, 400),
                               rtol=3e-5, atol=1e-7,
                               err_msg=f"advection[{field}]")
