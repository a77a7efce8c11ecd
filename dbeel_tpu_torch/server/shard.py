"""MyShard — the per-core cluster state hub (partial).

This module holds, for now, only the migration plan's vocabulary that
``server/migration.py`` imports: the action kinds and the (range,
action, target) entries a membership change plans.  ``MyShard`` itself
(ring, collections, gossip, replica fan-out and the shard request
handlers) lands here next.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

from ..cluster.local_comm import LocalShardConnection
from ..cluster.remote_comm import RemoteShardConnection

ShardConnection = Union[LocalShardConnection, RemoteShardConnection]


class MigrationAction:
    SEND = "send"
    DELETE = "delete"


@dataclass
class RangeAndAction:
    start: int
    end: int
    action: str  # MigrationAction
    connection: Optional[ShardConnection] = None
