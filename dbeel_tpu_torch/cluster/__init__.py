"""L4/L5: shard messaging planes and cluster distribution."""

from .messages import (  # noqa: F401
    ClusterMetadata,
    NodeMetadata,
    ShardEvent,
    ShardRequest,
    ShardResponse,
)
