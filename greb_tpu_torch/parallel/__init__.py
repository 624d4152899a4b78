"""Parallelism: ensembles (``ensemble``), latitude x member meshes
(``sharded``), the halo exchange between latitude shards (``halo``) and
meshes across processes (``multihost``)."""
from .halo import HaloExchange, halo_exchange_lat, make_sharded_extend
from .sharded import (Mesh, Sharded, make_mesh, make_plain_year_runners,
                      make_sharded_year_runners, shard_corr, shard_fastcirc,
                      shard_inputs, shard_state)

__all__ = [
    "HaloExchange", "halo_exchange_lat", "make_sharded_extend", "Mesh",
    "Sharded", "make_mesh", "make_plain_year_runners",
    "make_sharded_year_runners", "shard_corr", "shard_fastcirc",
    "shard_inputs", "shard_state",
]
