"""The CUDA year kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so these tests need a card and skip
without one.  They import no JAX; run them on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the repository's conftest files set JAX up).  The
grid is the main path's 96x48, with dense pole composites and 24
substeps, on a 10-day calendar; ``chip_smoke.py`` runs the full calendar.
Tolerances: tests/test_golden_year.py:29.
"""
import numpy as np
import pytest
import torch

from greb_tpu_torch.config import Numerics, GrebConfig
from greb_tpu_torch.model import core
from greb_tpu_torch.model.driver import GREB
from greb_tpu_torch.ops.cuda import year_kernel as yk

pytestmark = pytest.mark.cuda

NUM = Numerics(ndays_yr=10, jday_mon=(6, 4), time_flux=1, time_scnr=1)


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the year kernels have no CPU mode")
    return GREB(GrebConfig(numerics=NUM), verbose=False, device="cuda")


def _close(a, b, atol, name):
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=0,
                               atol=atol, err_msg=name)


def test_fluxcorr_year_kernel_matches_plain(model):
    s0 = model.initial_state()
    n0 = yk.fluxcorr_year.launches
    s_k, c_k = yk.fluxcorr_year(s0, 298.0, model.year_data)
    assert yk.fluxcorr_year.launches == n0 + 1
    s_p, c_p = yk.fluxcorr_year_plain(s0, 298.0, model.year_data)
    for name in ("ts", "ta", "to"):
        _close(getattr(s_k, name), getattr(s_p, name), 2e-2, name)
    _close(s_k.q, s_p.q, 3e-6, "q")
    _close(c_k.tf.mean(0), c_p.tf.mean(0), 1.0, "tf mean")
    _close(c_k.qf.mean(0), c_p.qf.mean(0), 1e-7, "qf mean")


def test_scenario_year_kernel_matches_plain(model):
    s0, corr = yk.fluxcorr_year_plain(model.initial_state(), 298.0,
                                      model.year_data)
    n0 = yk.scenario_year.launches
    s_k, o_k, a_k = yk.scenario_year(s0, corr, 680.0, model.year_data)
    assert yk.scenario_year.launches == n0 + 1
    s_p, o_p, a_p = yk.scenario_year_plain(s0, corr, 680.0, model.year_data)
    m_k = core.monthly_means(model.month_mat, o_k)
    m_p = core.monthly_means(model.month_mat, o_p)
    for v, (name, atol) in enumerate((("ts", 2e-2), ("ta", 2e-2),
                                      ("to", 2e-2), ("q", 3e-6),
                                      ("albedo", 5e-4))):
        _close(m_k[:, v], m_p[:, v], atol, f"monthly {name}")
        _close(a_k[v] / NUM.nstep_yr, a_p[v] / NUM.nstep_yr, atol,
               f"annual {name}")


def test_kernel_rejects_what_it_does_not_run(model):
    s0 = model.initial_state()
    with pytest.raises(ValueError, match="float32"):
        bad = s0.replace(ts=s0.ts.double())
        yk.fluxcorr_year(bad, 298.0, model.year_data)
