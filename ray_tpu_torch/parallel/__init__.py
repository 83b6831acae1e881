"""Parallelism of the port: ``mesh`` (a ``DeviceMesh`` over the ranks of
the default process group), ``context`` (the bound mesh), ``sharding``
(``ShardingConfig``'s axis rules, each rank's data and parameters:
``batch_shard``, ``seq_shard``, ``shard_params`` on pp and tp,
``gather_params``), ``ring_attention``
(ring and Ulysses sequence parallelism), ``pipeline`` (the fill-drain
microbatch schedule over the pp axis); ``launch`` spawns ranks that run
functions together."""
