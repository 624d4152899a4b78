"""Halo exchange between latitude shards (``greb_tpu.parallel.halo``).

The stencils reach +-2 rows in latitude (the meridional terms,
src/greb.f90:771-779) and +-3 columns in longitude.  The decomposition
shards latitude only, so every zonal stencil, the polar sub-cycles
included, is shard-local, and one exchange of 2 rows each way per
circulation substep covers every meridional dependency.  Shard i receives
the 2 rows above its first row from shard i-1 and the 2 rows below its
last from shard i+1; the outer shards receive zeros, which is the
reference's one-sided pole boundary (the dropped neighbour terms).

Within one process the exchange is a ``copy_`` between the shards'
tensors, which may lie on one device or on several.  Across processes it
is ``torch.distributed.batch_isend_irecv``: with NCCL between the cards'
own tensors, with gloo through host memory.  NCCL refuses two ranks on
one card ("duplicate GPU"), so processes that share a card use gloo, and
their 2-row halos go through pinned host memory (``HaloExchange``).

Two ways in:

- the plain runners (parallel/sharded.py) run each shard's plain step in
  a thread of its own, and the step's ``extend(x, 2)``
  (``make_sharded_extend``) is a collective among the threads of one ens
  row: each posts its edge rows, the last to arrive exchanges those of
  other processes, each takes its neighbours' (``HaloExchange.swap``);
- the slab kernels' runner (ops/cuda/slab.py) exchanges every local
  shard's edge buffer at once from one thread (``HaloExchange.edges``).
"""
from __future__ import annotations

import functools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

# seconds a shard's thread waits for the others at an exchange before the
# run is taken as failed (a thread that raised aborts the barrier first)
BARRIER_TIMEOUT = 300.0


class HaloExchange:
    """The exchange among the ``n_y`` latitude shards of one ens row.
    ``ranks[i]`` is the process that holds shard i (default: all this
    one's), ``group`` the process group across processes, ``tag`` this
    row's first message tag (rows of one mesh take disjoint tags)."""

    def __init__(self, n_y: int, ranks: Optional[Sequence[int]] = None,
                 group=None, tag: int = 0):
        self.n = n_y
        self.group = group
        self.rank = _rank(group)
        self.ranks = list(ranks) if ranks is not None else [self.rank] * n_y
        self.local = [i for i in range(n_y) if self.ranks[i] == self.rank]
        self.tag = tag
        self._posted: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._recv: Dict[Tuple[int, int], torch.Tensor] = {}
        self._barrier = threading.Barrier(len(self.local),
                                          action=self._remote_swap)

    # -- the plain runners: one thread a shard ---------------------------
    def swap(self, i: int, first: torch.Tensor, last: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Shard i's thread posts its first and last rows and gets (the
        rows above its first, the rows below its last) on its device, zeros
        past the poles.  Every local shard's thread calls it, in the same
        order."""
        self._posted[i] = (first, last)
        self._wait()
        dev = first.device
        above = (torch.zeros_like(first) if i == 0 else
                 self._rows(i - 1, 1, (i, 0)).to(dev, copy=True))
        below = (torch.zeros_like(last) if i == self.n - 1 else
                 self._rows(i + 1, 0, (i, 1)).to(dev, copy=True))
        self._wait()   # no shard posts again before every shard has read
        return above, below

    def abort(self) -> None:
        """Release the threads waiting at an exchange (one has failed)."""
        self._barrier.abort()

    def _wait(self) -> None:
        self._barrier.wait(BARRIER_TIMEOUT)

    def _rows(self, j: int, side: int, key) -> torch.Tensor:
        if j in self._posted and self.ranks[j] == self.rank:
            return self._posted[j][side]
        return self._recv[key]

    def _remote_swap(self) -> None:
        """The posted rows of shards whose neighbour is in another process,
        exchanged once all local shards have posted (the barrier's action:
        one thread)."""
        if len(self.local) == self.n:
            return
        self._recv = _p2p(self, {i: self._posted[i] for i in self.local})

    # -- the slab runner: every local shard from one thread --------------
    def edges(self, edge: Dict[int, torch.Tensor],
              halo: Dict[int, torch.Tensor]) -> int:
        """``halo[i][0]`` (the rows above shard i) from shard i-1's
        ``edge[i-1][1]`` (its last rows), ``halo[i][1]`` from shard i+1's
        ``edge[i+1][0]``, for every local shard i; the outer shards' stay as
        they are (zero).  Returns the copies made within the process."""
        recv = {}
        if len(self.local) < self.n:
            recv = _p2p(self, {i: (edge[i][0], edge[i][1])
                               for i in self.local})
        copies = 0
        for i in self.local:
            if i > 0:
                src = (edge[i - 1][1] if self.ranks[i - 1] == self.rank
                       else recv[(i, 0)])
                halo[i][0].copy_(src, non_blocking=True)
                copies += 1
            if i < self.n - 1:
                src = (edge[i + 1][0] if self.ranks[i + 1] == self.rank
                       else recv[(i, 1)])
                halo[i][1].copy_(src, non_blocking=True)
                copies += 1
        return copies


def _rank(group) -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group)
    return 0


def _p2p(ex: HaloExchange, posted: Dict[int, Tuple[torch.Tensor,
                                                   torch.Tensor]]):
    """One ``batch_isend_irecv`` of the edge rows that cross a process
    boundary: shard b's last rows to shard b+1 and shard b+1's first rows
    to shard b, for every boundary b, in one global order on every
    process.  NCCL sends the cards' tensors; another backend (gloo) sends
    through host memory (pinned where the rows are on a card).  Returns
    {(i, side): the rows received for local shard i}: side 0 above it,
    1 below it, on the device of its posted rows."""
    import torch.distributed as dist
    nccl = dist.get_backend(ex.group) == "nccl"
    ops: List = []
    got: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
    for b in range(ex.n - 1):
        for d, (src, dst) in enumerate(((b, b + 1), (b + 1, b))):
            # d 0: src's last rows become dst's rows above; d 1: src's first
            # rows become dst's rows below
            tag = ex.tag + 2 * b + d
            if ex.ranks[src] == ex.rank and ex.ranks[dst] != ex.rank:
                t = posted[src][1 - d].contiguous()
                if not nccl:
                    t = _host(t)
                ops.append(dist.P2POp(dist.isend, t, ex.ranks[dst],
                                      group=ex.group, tag=tag))
            elif ex.ranks[dst] == ex.rank and ex.ranks[src] != ex.rank:
                like = posted[dst][d]
                buf = torch.empty_like(like, memory_format=torch.contiguous_format)
                if not nccl:
                    buf = _host(buf, copy=False)
                got[(dst, d)] = (buf, like)
                ops.append(dist.P2POp(dist.irecv, buf, ex.ranks[src],
                                      group=ex.group, tag=tag))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return {k: buf.to(like.device, non_blocking=True)
            for k, (buf, like) in got.items()}


def _host(t: torch.Tensor, copy: bool = True) -> torch.Tensor:
    """A host tensor of ``t``'s shape (pinned where ``t`` is on a card),
    holding its values where ``copy``."""
    if t.device.type == "cpu":
        return t.contiguous() if copy else torch.empty_like(t)
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    if copy:
        out.copy_(t)
    return out


def halo_exchange_lat(x: torch.Tensor, width: int,
                      exchange: Optional[HaloExchange] = None,
                      shard: int = 0) -> torch.Tensor:
    """(..., R, X) -> (..., R + 2 width, X) with shard ``shard``'s
    neighbour rows over ``exchange`` (zeros past the poles, and everywhere
    without an exchange or with one shard)."""
    if exchange is None or exchange.n == 1:
        return torch.nn.functional.pad(x, (0, 0, width, width))
    above, below = exchange.swap(shard, x[..., :width, :],
                                 x[..., -width:, :])
    return torch.cat([above, x, below], dim=-2)


def make_sharded_extend(exchange: Optional[HaloExchange], shard: int):
    """An ``extend(x, width)`` callable (ops/stencils.py, fastcirc2.substep)
    backed by ``exchange``, for shard ``shard``."""
    return functools.partial(halo_exchange_lat, exchange=exchange,
                             shard=shard)
