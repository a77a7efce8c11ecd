"""Intra-node shard communication plane.

Role parity with reference src/local_shard.rs:8-46: every shard
owns an unbounded packet queue; a request packet carries a one-shot reply
channel.  Shards in one process share an event loop (the asyncio analog
of glommio executors on one machine), so the queue is a plain
``asyncio.Queue``.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Any, Optional


@dataclass
class ShardPacket:
    source_id: int
    message: list
    response_future: Optional[asyncio.Future] = None


class LocalShardConnection:
    """One per shard; the sender half is shared with every sibling."""

    def __init__(self, shard_id: int) -> None:
        self.id = shard_id
        self.queue: "asyncio.Queue[ShardPacket]" = asyncio.Queue()
        self.stop_event = asyncio.Event()

    async def send_message(self, source_id: int, message: list) -> None:
        await self.queue.put(ShardPacket(source_id, message))

    async def send_request(self, source_id: int, request: list) -> Any:
        """Request/response with a bounded(1)-style reply channel
        (local_shard.rs:31-45)."""
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        await self.queue.put(ShardPacket(source_id, request, fut))
        return await fut

    def send_stop(self) -> None:
        self.stop_event.set()
