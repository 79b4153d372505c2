"""Distribution substrate of the port: the one-process device mesh that
multi-device retrieval runs on (``parallel/sharding.py``)."""

from .sharding import DeviceMesh, all_gather, make_mesh, shard_put

__all__ = ["DeviceMesh", "all_gather", "make_mesh", "shard_put"]
