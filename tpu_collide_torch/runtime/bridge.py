"""BrokerBridge: the multi-host control plane (ROADMAP r2 #7).

The device data plane scales across hosts through JAX itself (a
`jax.sharding.Mesh` spanning multiple processes rides ICI within a pod
slice and DCN between slices — shard/step.py is already written against an
arbitrary mesh). What a multi-HOST deployment additionally needs is the
host-side control plane: heartbeats, leader election, replication, state
transfer and recovery all speak through `runtime.messaging.MessageBroker`,
which is in-process. This module bridges brokers across processes/machines
over plain TCP (stdlib asyncio, length-prefixed JSON frames — the
reference's equivalent layer was its Kafka deployment, messaging.py:70-182,
which the simulator sinks in sim/traffic.py already cover for the data
side).

Topology: every node runs one bridge. A bridge optionally LISTENS on a
port and optionally CONNECTS to peer addresses; any connected link relays
in both directions, so a star (all nodes -> one hub) or a full mesh both
work. Loop protection: each message is tagged with an `x-bridge-origin`
header; a bridge forwards only messages that do not already carry a
foreign origin (single-hop relay — in a star topology the hub re-forwards
to the other spokes exactly once via `relay=True`), and never re-publishes
its own node's messages back.

Delivery semantics are the broker's: at-most-once, drop-oldest under
backpressure (counted). Reconnects retry with backoff; outages surface in
`get_stats()`. This is the fabric the reference's HA tests pretended to
have — tests/test_bridge.py runs election and heartbeat failure detection
across two bridged brokers.
"""
from __future__ import annotations

import asyncio
import struct
from typing import Dict, Iterable, List, Optional, Tuple

from tpu_collide_torch.core.utils import get_logger
from tpu_collide_torch.runtime.messaging import Message, MessageBroker

logger = get_logger(__name__)

_HDR = struct.Struct("!I")
_MAX_FRAME = 16 * 1024 * 1024
ORIGIN_HEADER = "x-bridge-origin"


class BrokerBridge:
    """Relay selected topics of a local MessageBroker over TCP links.

    Args:
      broker: the local broker.
      node_id: unique name for loop protection.
      topics: topic names to relay (None = the control-plane topics every
        reliability component uses; pass an explicit list to widen).
      listen: optional (host, port) to accept peer links on (port 0 picks a
        free port; see `bound_port`).
      peers: addresses to dial out to.
      relay: hub mode — re-forward messages received from one link to the
        other links (star topologies). Leaf nodes leave it False.
    """

    def __init__(self, broker: MessageBroker, node_id: str,
                 topics: Optional[Iterable[str]] = None,
                 listen: Optional[Tuple[str, int]] = None,
                 peers: Iterable[Tuple[str, int]] = (),
                 relay: bool = False,
                 reconnect_s: float = 0.5):
        from tpu_collide_torch.runtime import messaging as m
        self.broker = broker
        self.node_id = node_id
        self.topics = list(topics) if topics is not None else [
            m.TOPIC_HEARTBEATS, m.TOPIC_ELECTION, m.TOPIC_REPLICATION,
            m.TOPIC_STATE_TRANSFER, m.TOPIC_RECOVERY, m.TOPIC_FAILOVER,
            m.TOPIC_SHARD_MGMT, m.TOPIC_LOAD_BALANCING, m.TOPIC_ALERTS,
        ]
        self._listen = listen
        self._peers = list(peers)
        self._relay = relay
        self._reconnect_s = reconnect_s
        self._server: Optional[asyncio.AbstractServer] = None
        self._links: List[asyncio.StreamWriter] = []
        self._tasks: List[asyncio.Task] = []
        self._running = False
        self.bound_port: Optional[int] = None
        self.stats: Dict[str, int] = {
            "sent": 0, "received": 0, "relayed": 0, "send_errors": 0,
            "reconnects": 0, "frames_dropped": 0,
        }

    # ---- lifecycle ----

    async def start(self) -> None:
        self._running = True
        if self._listen is not None:
            self._server = await asyncio.start_server(
                self._on_accept, self._listen[0], self._listen[1])
            self.bound_port = self._server.sockets[0].getsockname()[1]
        for addr in self._peers:
            self._tasks.append(asyncio.create_task(self._dial_loop(addr)))
        for topic in self.topics:
            self.broker.subscribe(topic, self._on_local_message)
        logger.info("bridge %s up (listen=%s peers=%s topics=%d)",
                    self.node_id, self._listen, self._peers,
                    len(self.topics))

    async def stop(self) -> None:
        self._running = False
        for topic in self.topics:
            self.broker.unsubscribe(topic, self._on_local_message)
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks.clear()
        for w in list(self._links):
            w.close()
        self._links.clear()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    # ---- local -> remote ----

    async def _on_local_message(self, msg: Message) -> None:
        origin = msg.headers.get(ORIGIN_HEADER)
        if origin is not None and origin != self.node_id:
            return                       # arrived over a link; don't echo
        out = Message(topic=msg.topic, value=msg.value, key=msg.key,
                      headers={**msg.headers, ORIGIN_HEADER: self.node_id},
                      id=msg.id, timestamp=msg.timestamp)
        await self._broadcast(out.serialize(), exclude=None)

    async def _broadcast(self, frame: bytes, exclude) -> None:
        dead = []
        for w in self._links:
            if w is exclude:
                continue
            try:
                w.write(_HDR.pack(len(frame)) + frame)
                await w.drain()
                self.stats["sent"] += 1
            except (ConnectionError, OSError):
                self.stats["send_errors"] += 1
                dead.append(w)
        for w in dead:
            self._drop_link(w)

    # ---- remote -> local ----

    async def _on_accept(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        self._links.append(writer)
        await self._recv_loop(reader, writer)

    async def _dial_loop(self, addr: Tuple[str, int]) -> None:
        while self._running:
            try:
                reader, writer = await asyncio.open_connection(*addr)
            except (ConnectionError, OSError):
                self.stats["reconnects"] += 1
                await asyncio.sleep(self._reconnect_s)
                continue
            self._links.append(writer)
            await self._recv_loop(reader, writer)
            if self._running:
                self.stats["reconnects"] += 1
                await asyncio.sleep(self._reconnect_s)

    async def _recv_loop(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        try:
            while self._running:
                hdr = await reader.readexactly(_HDR.size)
                (ln,) = _HDR.unpack(hdr)
                if ln > _MAX_FRAME:
                    self.stats["frames_dropped"] += 1
                    break
                frame = await reader.readexactly(ln)
                await self._handle_frame(frame, writer)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        except asyncio.CancelledError:
            raise
        finally:
            self._drop_link(writer)

    async def _handle_frame(self, frame: bytes, src) -> None:
        try:
            msg = Message.deserialize(frame)
        except Exception:
            self.stats["frames_dropped"] += 1
            return
        if msg.headers.get(ORIGIN_HEADER) == self.node_id:
            return                       # own message reflected back
        self.stats["received"] += 1
        await self.broker.publish(msg)
        if self._relay:
            self.stats["relayed"] += 1
            await self._broadcast(frame, exclude=src)

    def _drop_link(self, w) -> None:
        if w in self._links:
            self._links.remove(w)
            try:
                w.close()
            except Exception:
                pass

    def get_stats(self) -> Dict[str, int]:
        return {**self.stats, "links": len(self._links),
                "topics": len(self.topics)}
