"""greb_tpu_torch — the GREB climate model in PyTorch, with hand-written CUDA
kernels for an NVIDIA Hopper card (sm_90a).

A port of ``greb_tpu`` (JAX/Pallas) that runs the reference workload — the
flux-correction spin-up and the scenario years of ``GREB.run`` — with the
two fused year kernels in ``csrc/year_kernel.cu``.  The package imports
torch and numpy only.  The state path is float32 everywhere, so TF32 is
switched off here, at import, for matmuls and convolutions alike.

Entry points take ``device=None``, which means ``"cuda"``; without a card
they raise.  Pass ``device="cpu"`` to run the plain PyTorch versions of the
kernels (the tests do).
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from .config import (CO2Params, Diagnostics, Experiment, GrebConfig,  # noqa: E402
                     Numerics, PhysicsParams, config_from_namelist)

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA.  A CUDA device without a card raises: nothing
    here falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "greb_tpu_torch: CUDA is not available; pass device='cpu' to run "
            "the plain PyTorch path")
    return dev


# forcing.py reads resolve_device from here
from .forcing import (ClimForcing, Corrections, Derived,  # noqa: E402
                      ModelState, build_derived, initial_state, load_forcing,
                      synthetic_forcing)
from .grid import Grid, make_grid  # noqa: E402


def __getattr__(name):
    # the driver is imported on first use, not with the package
    if name == "GREB":
        from .model.driver import GREB
        return GREB
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "GREB", "GrebConfig", "Numerics", "PhysicsParams", "Diagnostics",
    "CO2Params", "Experiment", "ClimForcing", "Corrections", "Derived",
    "ModelState", "Grid", "make_grid", "build_derived", "initial_state",
    "load_forcing", "synthetic_forcing", "config_from_namelist",
    "resolve_device",
]
