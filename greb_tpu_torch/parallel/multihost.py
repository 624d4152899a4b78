"""Sharding across processes (``greb_tpu.parallel.multihost``).

The reference is one sequential process.  Here a mesh may span processes
(``torch.distributed``): each process holds a contiguous block of the
mesh's shards, on its own devices, and the latitude halos that cross a
process boundary go by ``batch_isend_irecv`` (parallel/halo.py).

- ``initialize``: ``torch.distributed.init_process_group`` at a
  ``tcp://host:port`` address, NCCL where each process has a card of its
  own, gloo otherwise: on the CPU, and where processes share a card (NCCL
  refuses two ranks on one card, "duplicate GPU"; the halo module then
  stages its 2-row halos through pinned host memory);
- ``global_mesh``: an (ens, y) mesh over every process's devices;
- ``host_local_rows``: the latitude rows this process's shards own;
- ``make_global_array`` / ``make_global_forcing``: each process builds only
  the rows (and members) of its own shards, on their devices.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .sharded import Mesh, Sharded


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join a job of ``num_processes`` processes whose rank 0 listens at
    ``coordinator_address`` ("host:port"); nothing for one process.
    ``backend`` defaults to NCCL where the host has a card for each
    process, else gloo."""
    import torch.distributed as dist
    if not num_processes or num_processes < 2:
        return
    if backend is None:
        backend = ("nccl" if torch.cuda.is_available()
                   and torch.cuda.device_count() >= num_processes
                   else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def shutdown() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _world() -> Tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def global_mesh(n_ens: int = 1, n_y: Optional[int] = None,
                local_devices: Optional[Sequence] = None) -> Mesh:
    """An (n_ens, n_y) mesh over every process of the job: process r holds
    the r-th block of n_ens * n_y / P shards in row order, on its
    ``local_devices`` in turn (default: its card, the one of its rank
    modulo the host's cards, or the CPU without one).  ``n_y`` defaults
    to P * len(local_devices) / n_ens."""
    P, rank = _world()
    if local_devices is None:
        local_devices = ([torch.device("cuda", rank % torch.cuda.device_count())]
                         if torch.cuda.is_available() else
                         [torch.device("cpu")])
    local_devices = [torch.device(d) for d in local_devices]
    if n_y is None:
        n_y = P * len(local_devices) // n_ens
    n = n_ens * n_y
    if n % P:
        raise ValueError(f"{n} shards do not split evenly over {P} "
                         f"processes")
    per = n // P
    devs = [[None] * n_y for _ in range(n_ens)]
    ranks = [[0] * n_y for _ in range(n_ens)]
    for i in range(n):
        e, y = divmod(i, n_y)
        ranks[e][y] = i // per
        devs[e][y] = local_devices[(i % per) % len(local_devices)]
    return Mesh(devs, ranks)


def host_local_rows(mesh: Mesh, ydim: int) -> Tuple[int, int]:
    """[lo, hi) latitude rows owned by this process's shards."""
    if ydim % mesh.n_y:
        raise ValueError(f"{ydim} rows do not split over {mesh.n_y} shards")
    rows = ydim // mesh.n_y
    ys = sorted({y for _, y in mesh.local()})
    return ys[0] * rows, (ys[-1] + 1) * rows


def make_global_array(mesh: Mesh, spec: Sequence[Optional[str]],
                      shape: Tuple[int, ...],
                      fill_local: Callable[[Tuple[slice, ...]], np.ndarray]
                      ) -> Sharded:
    """A ``Sharded`` array of global ``shape`` split by ``spec`` (one entry
    an axis: "y" splits it over the mesh's y shards, "ens" over its ens
    rows, None keeps it whole) where this process builds only its own
    shards: ``fill_local(index)`` returns the rows of the global index
    slices ``index``, placed on the shard's device."""
    if len(spec) != len(shape):
        raise ValueError(f"spec {tuple(spec)} for shape {tuple(shape)}")
    n = {"y": mesh.n_y, "ens": mesh.n_ens}
    parts = {}
    for k in mesh.local():
        idx = []
        for ax, size in zip(spec, shape):
            if ax is None:
                idx.append(slice(None))
                continue
            if size % n[ax]:
                raise ValueError(f"axis of {size} does not split over "
                                 f"{n[ax]} {ax!r} shards")
            c, i = size // n[ax], k[1] if ax == "y" else k[0]
            idx.append(slice(i * c, (i + 1) * c))
        a = np.ascontiguousarray(fill_local(tuple(idx)))
        parts[k] = torch.as_tensor(a, device=mesh.devices[k])
    y_axis = list(spec).index("y") - len(spec) if "y" in spec else -2
    return Sharded(mesh, parts, batched="ens" in spec, y_axis=y_axis)


def make_global_forcing(mesh: Mesh, arrs: Dict[str, np.ndarray]
                        ) -> Dict[str, Sharded]:
    """A forcing dict's fields split along the mesh's y shards, each
    process building only its own rows: (t, y, x) climatologies, the
    (y, x) z_topo and glacier, the (t, y) sw_solar."""
    out = {}
    for k, a in arrs.items():
        a = np.asarray(a)
        if k in ("z_topo", "glacier"):
            spec = ("y", None)
        elif k == "sw_solar":
            spec = (None, "y")
        else:
            spec = (None, "y", None)
        out[k] = make_global_array(mesh, spec, a.shape,
                                   lambda idx, a=a: a[idx])
    return out
