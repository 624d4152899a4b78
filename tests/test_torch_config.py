"""The port's config dataclasses against greb_tpu's (greb_tpu/config.py).

Every dataclass of greb_tpu_torch/config.py has a counterpart of the same
name in greb_tpu/config.py, and every field the two share has the
reference's default (nested configs included), so ``GREB(GrebConfig())``
runs what greb_tpu's does: the strict circulation unless
``fast_circulation=True``, which the two CLIs set unless
--strict-circulation.  The fields greb_tpu has and the port lacks would be
listed by name (``NOT_PORTED``): there are none.  The derived members
(``Numerics.dlon`` / ``dlat``, ``GrebConfig.physics_defaults``) and
``GREB.from_namelist`` give greb_tpu's values.
"""
import dataclasses

import numpy as np
import pytest

import greb_tpu.config as jconfig

import greb_tpu_torch.config as config

# greb_tpu's fields that the port's dataclasses lack
NOT_PORTED = {}
CLASSES = sorted(name for name, c in vars(config).items()
                 if isinstance(c, type) and dataclasses.is_dataclass(c)
                 and c.__module__ == config.__name__)


def _default(cls):
    # PhysicsParams has no field defaults: its defaults are default()
    return cls.default() if hasattr(cls, "default") else cls()


def _same_defaults(ours, theirs, path):
    """Each field of the port's ``ours`` equals greb_tpu's ``theirs``,
    nested dataclasses field by field."""
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        name = f"{path}.{f.name}"
        if dataclasses.is_dataclass(a):
            assert type(a).__name__ == type(b).__name__, name
            _same_defaults(a, b, name)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=name)


def test_every_config_class_has_a_counterpart():
    assert CLASSES == ["CO2Params", "Diagnostics", "Experiment",
                       "GrebConfig", "Numerics", "PhysicsParams"]
    assert all(dataclasses.is_dataclass(getattr(jconfig, n))
               for n in CLASSES)


@pytest.mark.parametrize("name", CLASSES)
def test_defaults_equal_greb_tpu(name):
    cls, jcls = getattr(config, name), getattr(jconfig, name)
    ours = {f.name for f in dataclasses.fields(cls)}
    theirs = {f.name for f in dataclasses.fields(jcls)}
    assert ours <= theirs, f"port-only fields {sorted(ours - theirs)}"
    assert theirs - ours == NOT_PORTED.get(name, set())
    _same_defaults(_default(cls), _default(jcls), name)


def test_the_default_transport_is_the_strict_circulation():
    assert config.GrebConfig().fast_circulation is False
    assert jconfig.GrebConfig().fast_circulation is False


def test_field_order_equals_greb_tpu():
    for name in CLASSES:
        assert [f.name for f in dataclasses.fields(getattr(config, name))] \
            == [f.name for f in dataclasses.fields(getattr(jconfig, name))]


@pytest.mark.parametrize("grid", [(96, 48), (192, 96), (768, 384), (48, 24)])
def test_derived_members_equal_greb_tpu(grid):
    x, y = grid
    ours = config.Numerics(xdim=x, ydim=y)
    theirs = jconfig.Numerics(xdim=x, ydim=y)
    for name in ("dlon", "dlat", "ndt_days", "nstep_yr", "nsub_crcl"):
        assert getattr(ours, name) == getattr(theirs, name), name
    _same_defaults(config.GrebConfig().physics_defaults(),
                   jconfig.GrebConfig().physics_defaults(), "physics")


NAMELIST = """&numerics_par
 time_flux = 2
 time_scnr = 3
 ipx = 5
 ipy = 7
/
&physics_par
 ct_sens = 23.0
/
&diagnostics_par
 output_file = 'out/scen'
/
&co2_par
 co2_ppm = 560
/
"""


def test_from_namelist_equals_greb_tpu(tmp_path):
    from greb_tpu_torch.model.driver import GREB

    path = tmp_path / "namelist"
    path.write_text(NAMELIST)
    m = GREB.from_namelist(str(path), device="cpu", verbose=False)
    assert m.device.type == "cpu"
    cfg, params = jconfig.config_from_namelist(str(path))
    _same_defaults(m.cfg, cfg, "GrebConfig")
    _same_defaults(m.params, params, "PhysicsParams")
    assert (m.num.time_flux, m.num.ipy, float(m.params.ct_sens)) == \
        (2, 7, 23.0)
    assert m.cfg.diagnostics.output_file == "out/scen"
