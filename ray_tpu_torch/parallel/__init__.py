"""Parallelism of the port: ``mesh`` (a ``DeviceMesh`` over the ranks of
the default process group), ``context`` (the bound mesh), ``sharding``
(``ShardingConfig``'s axis rules) and ``ring_attention`` (ring and Ulysses
sequence parallelism); ``launch`` spawns ranks that run functions
together."""
