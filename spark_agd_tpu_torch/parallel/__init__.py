"""Data parallelism over a mesh of devices: ``mesh`` (meshes, placement),
``dist_smooth`` (the per-shard sums and their combine), ``multihost``
(meshes across processes over ``torch.distributed``) and ``dryrun``."""
