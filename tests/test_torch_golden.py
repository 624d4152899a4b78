"""The port's slice-level parity gate: the 96x48 golden year on the CPU.

The port (plain PyTorch versions of the year kernels, full 730-step
calendar, 24 substeps) runs one flux-correction year at 298 ppm and one
scenario year at 680 ppm on the synthetic forcing, and reproduces
tests/golden/golden_year_96x48.npz — the NumPy oracle's line-by-line
transliteration of the reference — at the tolerances of
tests/test_golden_year.py:29, all rows, poles included: with the folded
circulation (the main path) and with the strict term-by-term stencils
(``fast_circulation=False``, tests/test_golden_year.py's "strict" id).
"""
import os

import numpy as np
import pytest
import torch

from greb_tpu_torch.config import GrebConfig, Numerics
from greb_tpu_torch.model.driver import GREB

# The fields are small: one intra-op thread.  More threads only contend
# with the other test workers (measured ~7x slower under -n 6).
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "golden_year_96x48.npz")
TOL = {"ts": 2e-2, "ta": 2e-2, "to": 2e-2, "q": 3e-6, "albedo": 5e-4}


def _run(fast_circulation=True):
    m = GREB(GrebConfig(numerics=Numerics(time_flux=1, time_scnr=1),
                        fast_circulation=fast_circulation), verbose=False,
             device="cpu")
    state_fc, corr = m.flux_correction(co2=298.0)
    state, monthly, _ = m.run_scenario(
        corr, state=state_fc, co2_series=np.full(1, 680.0, np.float32))
    return state_fc, corr, state, monthly[0]


@pytest.fixture(scope="module")
def run():
    return _run()


@pytest.fixture(scope="module")
def strict_run():
    return _run(fast_circulation=False)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _check_spinup(run, golden):
    state_fc, corr, _, _ = run
    for k, g in (("ts", "fc_ts"), ("ta", "fc_ta"), ("to", "fc_to")):
        np.testing.assert_allclose(getattr(state_fc, k).numpy(), golden[g],
                                   rtol=0, atol=2e-2, err_msg=g)
    np.testing.assert_allclose(state_fc.q.numpy(), golden["fc_q"], rtol=0,
                               atol=3e-6, err_msg="fc_q")
    np.testing.assert_allclose(state_fc.cap_surf.numpy(),
                               golden["fc_cap_surf"], rtol=1e-5, atol=0)
    np.testing.assert_allclose(corr.tf.mean(dim=0).numpy(),
                               golden["corr_tf_mean"], rtol=0, atol=1.0)
    np.testing.assert_allclose(corr.qf.mean(dim=0).numpy(),
                               golden["corr_qf_mean"], rtol=0, atol=1e-7)


def _check_scenario(run, golden):
    _, _, state, monthly = run
    want = golden["monthly"]                         # (12, 5, 48, 96)
    for v, name in enumerate(("ts", "ta", "to", "q", "albedo")):
        np.testing.assert_allclose(monthly[:, v], want[:, v], rtol=0,
                                   atol=TOL[name], err_msg=name)
    for k, g in (("ts", "end_ts"), ("ta", "end_ta"), ("to", "end_to")):
        np.testing.assert_allclose(getattr(state, k).numpy(), golden[g],
                                   rtol=0, atol=3e-2, err_msg=g)
    np.testing.assert_allclose(state.q.numpy(), golden["end_q"], rtol=0,
                               atol=5e-6, err_msg="end_q")


def test_spinup_year_matches_golden(run, golden):
    _check_spinup(run, golden)


def test_scenario_year_matches_golden(run, golden):
    _check_scenario(run, golden)


def test_strict_spinup_year_matches_golden(strict_run, golden):
    _check_spinup(strict_run, golden)


def test_strict_scenario_year_matches_golden(strict_run, golden):
    _check_scenario(strict_run, golden)
