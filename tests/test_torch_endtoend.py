"""The port end to end on the CPU, against ``greb_tpu`` on the same forcing.

* ``GREB.run()`` at 48x24 on a 10-day calendar (2 spin-up + 3 scenario
  years) writes the reference's binary stream; the file reads back equal
  to the returned monthly means, and agrees with ``greb_tpu``'s run
  (XLA path, folded circulation) within the tolerances stated below.
* ``convert.params_from_numpy`` / ``forcing_from_numpy`` carry the JAX
  package's values across: one spin-up step computed from them matches
  the JAX step.
* Asking for the CUDA kernel where there is no card raises; nothing falls
  back to the plain version.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from greb_tpu.config import CO2Params as JCO2
from greb_tpu.config import Diagnostics as JDiag
from greb_tpu.config import GrebConfig as JConfig
from greb_tpu.config import Numerics as JNumerics
from greb_tpu.config import PhysicsParams as JParams
from greb_tpu.model import core as jcore
from greb_tpu.model.driver import GREB as JGREB

from greb_tpu_torch.config import CO2Params, Diagnostics, GrebConfig, Numerics
from greb_tpu_torch.convert import forcing_from_numpy, params_from_numpy
from greb_tpu_torch.io.binio import read_output
from greb_tpu_torch.model import core
from greb_tpu_torch.model.driver import GREB

# The fields are small: one intra-op thread.  More threads only contend
# with the other test workers (measured ~7x slower under -n 6).
torch.set_num_threads(1)

SMALL = dict(xdim=48, ydim=24, ndays_yr=10, jday_mon=(6, 4), time_flux=2,
             time_scnr=3)


def _jax_leaves(obj):
    return {k: np.asarray(getattr(obj, k)) for k in obj.__dataclass_fields__}


@pytest.fixture(scope="module")
def jax_model():
    cfg = JConfig(numerics=JNumerics(**SMALL), co2=JCO2(co2_ppm=(680.0,)),
                  diagnostics=JDiag(console=False), fast_circulation=True)
    return JGREB(cfg, verbose=False)


def test_run_writes_output_matching_greb_tpu(jax_model, tmp_path):
    """Output stream of the port vs greb_tpu after 2+3 years of the 10-day
    calendar.  Tolerance per variable: 5e-3 K for temperatures, 2e-6 for
    q, 2e-4 for albedo (absolute).  Five compressed years integrate the
    two libraries' float32 grouping differences; the golden year
    (tests/test_torch_golden.py) holds the full calendar to the oracle."""
    j_out = str(tmp_path / "jax_scenario")
    jax_model.run(output_path=j_out)

    cfg = GrebConfig(numerics=Numerics(**SMALL),
                     co2=CO2Params(co2_ppm=(680.0,)),
                     diagnostics=Diagnostics(console=False),
                     fast_circulation=True)
    m = GREB(cfg, forcing=forcing_from_numpy(_jax_leaves(jax_model.forcing),
                                             "cpu"),
             verbose=False, device="cpu")
    out = str(tmp_path / "scenario")
    state, corr, monthly, diags = m.run(output_path=out)

    back = read_output(out, 48, 24)
    assert back.shape == (SMALL["time_scnr"] * 2, 5, 24, 48)
    np.testing.assert_array_equal(back, monthly.reshape(back.shape))
    assert np.isfinite(back).all()
    assert len(diags) == SMALL["time_scnr"]

    want = read_output(j_out, 48, 24)
    for v, atol in enumerate((5e-3, 5e-3, 5e-3, 2e-6, 2e-4)):
        assert np.allclose(back[:, v], want[:, v], rtol=0, atol=atol), (
            v, float(np.abs(back[:, v] - want[:, v]).max()))


def test_convert_carries_jax_values_into_a_step(jax_model):
    """One spin-up step at 48x24 from JAX-side params and forcing: the
    converted params are equal leaf by leaf, and the step's new state and
    correction slices match the JAX step (rtol 1e-5; atol 1e-3 K, 1e-7 q,
    1e-2 W/m^2 tf)."""
    jp = JParams.default().replace(ct_sens=21.0)
    p = params_from_numpy(_jax_leaves(jp))
    for f in dataclasses.fields(p):
        np.testing.assert_array_equal(np.asarray(getattr(p, f.name)),
                                      np.asarray(getattr(jp, f.name)))

    jm = JGREB(jax_model.cfg, params=jp,
               forcing=jax_model.forcing, verbose=False)
    m = GREB(GrebConfig(numerics=Numerics(**SMALL), fast_circulation=True),
             params=p,
             forcing=forcing_from_numpy(_jax_leaves(jax_model.forcing), "cpu"),
             verbose=False, device="cpu")
    plan, (const,) = jm._fastcirc_split()
    fx = jax.tree.map(lambda a: a[3], jm.sfx)
    js, (jtf, _, jqf) = jcore.fluxcorr_step(
        jm.initial_state(), fx, jnp.float32(298.0), jm.md, jm.st, jm.num,
        jm.exp, fastcirc=(plan, const))
    s, (tf, _, qf) = core.fluxcorr_step(m.initial_state(), m.sfx.at(3),
                                        np.float32(298.0), m.md, m.num,
                                        m.fold)
    for name, atol in (("ts", 1e-3), ("ta", 1e-3), ("to", 1e-3),
                       ("q", 1e-7)):
        np.testing.assert_allclose(getattr(s, name).numpy(),
                                   np.asarray(getattr(js, name)), rtol=1e-5,
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jtf), rtol=1e-5,
                               atol=1e-2)
    np.testing.assert_allclose(qf.numpy(), np.asarray(jqf), rtol=1e-5,
                               atol=1e-7)


def test_cuda_kernel_request_raises_without_a_card(monkeypatch):
    """The wrapper takes its plain version only for CPU tensors.  Asked for
    the kernel (here: a CUDA build with no toolkit and no card), it raises
    instead of running the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from greb_tpu_torch.ops.cuda import build
    from greb_tpu_torch.ops.cuda import year_kernel as yk

    monkeypatch.setattr(build, "BUILD_DIR", "/nonexistent-greb-build")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        yk._lib()

    m = GREB(GrebConfig(numerics=Numerics(**SMALL), fast_circulation=True),
             verbose=False, device="cpu")
    state = m.initial_state()
    meta = dataclasses.replace(state, ts=state.ts.to("meta"))
    with pytest.raises(ValueError, match="year kernels run on cuda"):
        yk.fluxcorr_year(meta, 298.0, m.year_data)


def test_namelist_config_matches_greb_tpu(tmp_path):
    """The port's namelist reader and config_from_namelist on an in-repo-made
    namelist give the same run settings and physics as greb_tpu's."""
    from greb_tpu.config import config_from_namelist as j_config
    from greb_tpu_torch.config import config_from_namelist
    from greb_tpu_torch.io.namelist import write_namelist

    path = str(tmp_path / "namelist")
    write_namelist({
        "numerics_par": {"time_flux": 3, "time_scnr": 50, "ipx": 12,
                         "ipy": 30, "year0": 1950},
        "physics_par": {"ct_sens": 21.5, "kappa": 7.5e5},
        "co2_par": {"co2_flux": 280.0, "co2_ppm": [560.0, 600.0, -1.0]},
        "diagnostics_par": {"output_file": "out/scenario", "ens_id": "007"},
    }, path)
    cfg, p = config_from_namelist(path)
    jcfg, jp = j_config(path)
    for group in ("numerics", "diagnostics", "co2", "experiment"):
        ours, theirs = getattr(cfg, group), getattr(jcfg, group)
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(theirs, f.name), (
                group, f.name)
    assert cfg.diagnostics.output_file_full == "out/scenario_007"
    np.testing.assert_array_equal(cfg.co2.series(4), jcfg.co2.series(4))
    for f in dataclasses.fields(p):
        np.testing.assert_array_equal(np.asarray(getattr(p, f.name)),
                                      np.asarray(getattr(jp, f.name)),
                                      err_msg=f.name)


def test_input_dir_forcing_round_trips(tmp_path):
    """--input-dir: a reference-format input directory (written with the
    port's own writer) loads back bit-exact as the model's forcing."""
    from greb_tpu_torch.io.synthetic import (make_synthetic_forcing,
                                             write_forcing_dir)
    arrs = make_synthetic_forcing(48, 24, 20, 10)
    write_forcing_dir(arrs, str(tmp_path))
    m = GREB(GrebConfig(numerics=Numerics(**SMALL), fast_circulation=True),
             input_dir=str(tmp_path), verbose=False, device="cpu")
    for k, want in arrs.items():
        np.testing.assert_array_equal(getattr(m.forcing, k).numpy(), want,
                                      err_msg=k)
