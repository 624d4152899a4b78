"""The port's config dataclasses against greb_tpu's (greb_tpu/config.py).

Every dataclass of greb_tpu_torch/config.py has a counterpart of the same
name in greb_tpu/config.py, and every field the two share has the
reference's default (nested configs included), so ``GREB(GrebConfig())``
runs what greb_tpu's does: the strict circulation unless
``fast_circulation=True``, which the two CLIs set unless
--strict-circulation.  The fields greb_tpu has and the port lacks are
listed by name (``NOT_PORTED``); ROADMAP Queue 1 item 7 queues them.
"""
import dataclasses

import numpy as np
import pytest

import greb_tpu.config as jconfig

import greb_tpu_torch.config as config

# greb_tpu's fields that the port's dataclasses lack (ROADMAP Queue 1
# item 7: public API parity)
NOT_PORTED = {
    "Diagnostics": {"store_monthly"},
    "GrebConfig": {"check_finite_every", "unroll_circulation", "use_pallas"},
    "Numerics": {"ireal"},
}
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
