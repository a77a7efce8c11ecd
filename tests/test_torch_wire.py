"""The wire of dbeel_tpu_torch against dbeel_tpu: the error taxonomy,
the node config, the shard message schema, the intra-node queue, the
inter-node RPC plane and the framed server base.  The same seeded
inputs go through both packages; packed frames must be byte-identical
(SHA-256 of their concatenation) and every decision must agree.
Sockets bind port 0."""

import asyncio
import dataclasses
import hashlib

import numpy as np
import pytest

from conftest import run

from dbeel_tpu import config as jconfig
from dbeel_tpu import errors as jerrors
from dbeel_tpu.cluster import local_comm as jlocal
from dbeel_tpu.cluster import messages as jmsgs
from dbeel_tpu.cluster import remote_comm as jremote
from dbeel_tpu.server import framed as jframed
from dbeel_tpu_torch import config as tconfig
from dbeel_tpu_torch import errors as terrors
from dbeel_tpu_torch.cluster import local_comm as tlocal
from dbeel_tpu_torch.cluster import messages as tmsgs
from dbeel_tpu_torch.cluster import remote_comm as tremote
from dbeel_tpu_torch.server import framed as tframed

# Both packages side by side: (errors, messages, remote_comm).
PKGS = {
    "ref": (jerrors, jmsgs, jremote),
    "port": (terrors, tmsgs, tremote),
}

# Every msgpack int width, both signs.
INTS = [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
    2**63 - 1, 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
    -2**31, -2**31 - 1, -2**63,
]
# Timestamps are int64 on the wire.
TS = [t for t in INTS if -2**63 <= t < 2**63]


@pytest.fixture(autouse=True)
def _no_armed_faults(monkeypatch):
    """The fault seam is armed from the environment at import: start
    and end every test with no fault armed in either package."""
    for var in ("DBEEL_REMOTE_FAULTS", "DBEEL_REMOTE_FAULTS_DELAY_S",
                "DBEEL_NO_PEER_PIPELINE"):
        monkeypatch.delenv(var, raising=False)
    jremote.clear_faults()
    tremote.clear_faults()
    yield
    jremote.clear_faults()
    tremote.clear_faults()


# ---------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------


def test_error_kinds_and_classes_agree():
    assert set(terrors._BY_KIND) == set(jerrors._BY_KIND)
    assert terrors.ERROR_CLASSES == jerrors.ERROR_CLASSES
    assert terrors._BENIGN_KINDS == jerrors._BENIGN_KINDS
    assert terrors._CONNECTION_KINDS == jerrors._CONNECTION_KINDS
    for name in dir(jerrors):
        if name.startswith("ERROR_CLASS_") and name != "ERROR_CLASSES":
            assert getattr(terrors, name) == getattr(jerrors, name)


def _verdict(E, exc):
    cls = E.classify_error(exc)
    return cls, E.is_retryable_class(cls)


@pytest.mark.parametrize("kind", sorted(jerrors._BY_KIND))
def test_classify_and_from_wire_agree(kind):
    rng = np.random.default_rng(len(kind))
    message = f"{kind} {int(rng.integers(1 << 30))}"
    got = {}
    for name, (E, _M, _R) in PKGS.items():
        exc = E._BY_KIND[kind](message)
        back = E.from_wire(exc.to_wire())
        assert type(back) is E._BY_KIND[kind]
        assert str(back) == message
        got[name] = (exc.kind, *_verdict(E, exc), back.to_wire())
    assert got["port"] == got["ref"]


def test_classify_non_dbeel_errors_agree():
    def cases():
        return [
            asyncio.TimeoutError(), OSError("reset"),
            ConnectionResetError(), asyncio.IncompleteReadError(b"", 4),
            EOFError(), ValueError("x"), KeyError("k"),
        ]

    for j, t in zip(cases(), cases()):
        assert _verdict(terrors, t) == _verdict(jerrors, j), type(t)
    for cls in (None, "other", "bogus") + jerrors.ERROR_CLASSES:
        assert terrors.is_retryable_class(cls) == (
            jerrors.is_retryable_class(cls)
        )


def test_from_wire_unknown_and_unparseable():
    for payload in (["Mystery", "m"], ["KeyNotFound"], None, 7, []):
        j, t = jerrors.from_wire(payload), terrors.from_wire(payload)
        assert (t.kind, str(t), t.to_wire()) == (
            j.kind, str(j), j.to_wire()
        )
        assert _verdict(terrors, t) == _verdict(jerrors, j)


# ---------------------------------------------------------------------
# config
# ---------------------------------------------------------------------


def _sample_argv(seed):
    """A seeded draw over the reference parser's flags: about a third
    of them set, ints drawn from [0, 2^20), choices from their list."""
    rng = np.random.default_rng(seed)
    argv = []
    for action in jconfig.build_parser()._actions:
        if not action.option_strings or action.dest == "help":
            continue
        if rng.random() > 0.35:
            continue
        flag = action.option_strings[0]
        if action.nargs == 0:
            argv.append(flag)
        elif action.nargs == "*":
            argv += [flag] + [
                f"10.0.0.{int(i)}:{20000 + int(i)}"
                for i in rng.integers(1, 200, size=int(rng.integers(0, 3)))
            ]
        elif action.choices:
            argv += [flag, str(rng.choice(list(action.choices)))]
        elif action.type is int:
            argv += [flag, str(int(rng.integers(0, 1 << 20)))]
        else:
            argv += [flag, f"s{int(rng.integers(1 << 30))}"]
    return argv


def _parse_both(argv):
    j, t = jconfig.parse_args(list(argv)), tconfig.parse_args(list(argv))
    assert dataclasses.asdict(t) == dataclasses.asdict(j), argv
    return j, t


def test_config_defaults_and_flags_agree():
    j, t = _parse_both([])
    assert dataclasses.asdict(tconfig.Config()) == (
        dataclasses.asdict(jconfig.Config())
    )
    assert (t.compaction_backend, t.memtable_kind) == ("auto", "auto")
    assert (t.foreground_tasks_shares, t.background_tasks_shares) == (
        1000, 250
    )

    def flags(mod):
        return sorted(
            (a.option_strings[0], a.dest, repr(a.default), a.nargs,
             a.choices and tuple(a.choices), getattr(a.type, "__name__", None))
            for a in mod.build_parser()._actions if a.option_strings
        )

    assert flags(tconfig) == flags(jconfig)


@pytest.mark.parametrize(
    "argv",
    [["--compaction-backend", c] for c in (
        "auto", "device", "device_full", "coalesced", "distributed",
        "cpu", "native", "heap")]
    + [["--memtable-kind", k] for k in ("auto", "sorted", "hash", "arena")],
)
def test_config_choices_agree(argv):
    _parse_both(argv)


@pytest.mark.parametrize("seed", range(6))
def test_config_seeded_flags_agree(seed):
    j, t = _parse_both(_sample_argv(seed))
    for shard in (0, 1, 7, 63):
        assert t.db_port(shard) == j.db_port(shard)
        assert t.remote_port(shard) == j.remote_port(shard)
    assert t.gc_grace_s() == j.gc_grace_s()
    for ms in (-1, 0, 1, 12345):
        kw = dict(gc_grace_ms=ms, hint_ttl_ms=ms * 7 + 3)
        assert t.replace(**kw).gc_grace_s() == j.replace(**kw).gc_grace_s()
    with pytest.raises(SystemExit):
        tconfig.parse_args(["--memtable-kind", "bogus"])


# ---------------------------------------------------------------------
# messages
# ---------------------------------------------------------------------


def _node(M, rng, i, tokens):
    toks = None
    if tokens == "single":
        toks = [[int(rng.integers(2**32))] for _ in range(2)]
    elif tokens == "multi":
        toks = [[int(x) for x in rng.integers(2**32, size=3)]
                for _ in range(2)]
    return M.NodeMetadata(
        f"node-{i}", f"10.0.{i}.1", 20000 + 10 * i, [0, 1],
        30000 + i, 10000 + i, toks,
    )


def _frames(E, M, seed):
    """Every constructor of the schema on seeded inputs (the same
    ``seed`` gives the same inputs in either package)."""
    rng = np.random.default_rng(seed)

    def key():
        return rng.bytes(int(rng.integers(0, 40)))

    def col():
        return f"col{int(rng.integers(0, 1000))}"

    nodes = [_node(M, rng, i, t)
             for i, t in enumerate((None, "single", "multi"))]
    digest = {"node": "n1", "seq": int(rng.integers(1 << 40)),
              "ops_per_s": float(rng.random()), "degraded": False,
              "findings": ["shed_storm"], "boot": "ab"}
    SR, SP, GE = M.ShardRequest, M.ShardResponse, M.GossipEvent
    out = [
        M.ShardEvent.gossip(GE.alive(nodes[2])),
        M.ShardEvent.set(col(), key(), key(), TS[int(rng.integers(len(TS)))]),
        SR.ping(), SR.telemetry_digest(), SR.rearm(), SR.get_metadata(),
        SR.get_collections(), SR.drop_collection(col()),
        SR.create_collection(col(), 3),
        SR.create_collection(col(), 1, quotas={"ops_per_sec": 5}),
        SR.create_collection(col(), 2, index=["v", "w"]),
        SR.create_collection(col(), 2, {"bytes_per_sec": 9}, ("v",)),
        SR.range_digest(col(), 0, 2**32 - 1, 16),
        SR.range_pull(col(), 5, 2**31, None, 100),
        SR.range_pull(col(), 5, 2**31, key(), 100, [1, 3], 16),
        SR.scan(col(), 0, 2**32, None, None, 65536, 256 << 10, True),
        SR.scan(col(), 7, 9, key(), b"pre", 10, 1 << 20, False,
                spec=key(), qos=0),
        SR.watch_feed(col(), int(rng.integers(1 << 62)), 17,
                      [[0, 2**31], [2**31, 2**32]], 256, 1 << 16),
        SR.watch_feed(col(), 3, 0, [], 1, 1, spec=b"s", qos=1),
        SR.range_push(col(), [[key(), key(), t] for t in TS[:5]]),
    ]
    extras = [
        {}, {"deadline_ms": 1700000000123}, {"trace_id": 2**40 + 5},
        {"deadline_ms": 1, "trace_id": 2, "qos": 0}, {"qos": 2},
        {"deadline_ms": -5, "trace_id": 0, "qos": None},
    ]
    for kw in extras:
        ts = TS[int(rng.integers(len(TS)))]
        out += [
            SR.set(col(), key(), key(), ts, **kw),
            SR.delete(col(), key(), ts, **kw),
            SR.get(col(), key(), **kw),
            SR.get_digest(col(), key(), **kw),
            SR.multi_set(col(), [[key(), key(), t] for t in TS[:4]], **kw),
            SR.multi_get(col(), [key() for _ in range(3)], **kw),
        ]
    out += [
        SP.pong(), SP.telemetry_digest(digest), SP.get_metadata(nodes),
        SP.get_collections([("a", 1), ("b", 3, {"ops_per_sec": 2}),
                            ("c", 2, None, ["v"])]),
        SP.get(None), SP.get_digest(None),
        SP.multi_get([None, (key(), 5), [b"", -1]]),
        SP.range_digest([1, 2, 300], [2**32 - 1, 0, 77]),
        SP.range_pull([[key(), key(), t] for t in TS[:3]]),
        SP.scan([[key(), None, 1]], True),
        SP.scan([[key(), key(), 2]], False, cover=key(), scanned_rows=10,
                scanned_bytes=2**33, agg={"sum": 1.5, "n": 3}),
        SP.watch_feed([[key(), key(), 1, 2]], 5, 6, 1),
    ]
    for kind in (SP.SET, SP.DELETE, SP.MULTI_SET, SP.RANGE_PUSH,
                 SP.CREATE_COLLECTION, SP.DROP_COLLECTION, SP.REARM):
        out.append(SP.empty(kind))
    for ts in TS:
        value = key()
        out += [SP.get((value, ts)), SP.get_digest((value, ts)),
                SP.get_digest((bytearray(value), ts))]
    for kind in sorted(E._BY_KIND):
        out.append(SP.error(E._BY_KIND[kind](f"{kind}: {key()!r}")))
    out += [
        GE.alive(nodes[0]), GE.alive(nodes[1]), GE.dead("node-9"),
        GE.health("node-1", int(rng.integers(1 << 50)), digest),
        GE.create_collection(col(), 3),
        GE.create_collection(col(), 3, quotas={"ops_per_sec": 1}),
        GE.create_collection(col(), 3, index=["v"]),
        GE.drop_collection(col()),
        M.ClusterMetadata(nodes, [("a", 1), ("b", 3)]).to_wire(),
        M.ClusterMetadata(nodes[:1], [], epoch=2**33).to_wire(),
    ]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_every_constructor_packs_byte_identical(seed):
    jf = _frames(jerrors, jmsgs, seed)
    tf = _frames(terrors, tmsgs, seed)
    assert len(jf) == len(tf) > 100
    jb = [jmsgs.pack_message(f) for f in jf]
    tb = [tmsgs.pack_message(f) for f in tf]
    for i, (a, b) in enumerate(zip(jb, tb)):
        assert a == b, (i, jf[i])
    assert hashlib.sha256(b"".join(tb)).hexdigest() == (
        hashlib.sha256(b"".join(jb)).hexdigest()
    )
    # Each side decodes the other's bytes to equal objects.
    for a, b in zip(jb, tb):
        assert tmsgs.unpack_message(a) == jmsgs.unpack_message(b)
        assert tmsgs.unpack_message(a) == tmsgs.unpack_message(b)


def test_get_digest_canonical_across_int_widths():
    """The coordinator predicts a replica's digest bytes: they are the
    reference's, minimal-width ints included."""
    for ts in TS:
        for value in (b"", b"x", bytes(range(256)) * 3):
            j = jmsgs.pack_message(jmsgs.ShardResponse.get_digest((value, ts)))
            t = tmsgs.pack_message(tmsgs.ShardResponse.get_digest((value, ts)))
            assert t == j, ts
    assert tmsgs.pack_message(tmsgs.ShardResponse.get_digest(None)) == (
        jmsgs.pack_message(jmsgs.ShardResponse.get_digest(None))
    )


def test_metadata_and_gossip_round_trip():
    rng_seed = 11
    for tokens in (None, "single", "multi"):
        j = _node(jmsgs, np.random.default_rng(rng_seed), 4, tokens)
        t = _node(tmsgs, np.random.default_rng(rng_seed), 4, tokens)
        assert t.to_wire() == j.to_wire()
        back = tmsgs.NodeMetadata.from_wire(
            jmsgs.unpack_message(jmsgs.pack_message(j.to_wire()))
        )
        assert dataclasses.astuple(back) == dataclasses.astuple(
            jmsgs.NodeMetadata.from_wire(j.to_wire())
        )
        assert hash(t) == hash(j)
    for epoch in (0, 5):
        cm = [M.ClusterMetadata([_node(M, np.random.default_rng(1), 1, None)],
                                [("x", 2)], epoch) for M in (jmsgs, tmsgs)]
        wire = jmsgs.pack_message(cm[0].to_wire())
        assert tmsgs.pack_message(cm[1].to_wire()) == wire
        back = tmsgs.ClusterMetadata.from_wire(tmsgs.unpack_message(wire))
        assert (back.epoch, back.collections) == (epoch, [("x", 2)])
    digest = {"node": "n1", "seq": 3, "level": 1}
    for d in (None, digest):
        jb = jmsgs.serialize_gossip_message(
            "n1#ab", jmsgs.GossipEvent.dead("n9"), d)
        tb = tmsgs.serialize_gossip_message(
            "n1#ab", tmsgs.GossipEvent.dead("n9"), d)
        assert tb == jb
        assert tmsgs.deserialize_gossip_message(jb) == (
            jmsgs.deserialize_gossip_message(tb)
        )
    # A trailing non-dict element is not a digest, in both.
    odd = jmsgs.pack_message(["s", ["dead", "n"], [1]])
    assert tmsgs.deserialize_gossip_message(odd) == (
        jmsgs.deserialize_gossip_message(odd)
    )


def test_qos_stamps_and_response_to_result_agree():
    for value in (None, True, False, 0, 1, 2, 3, -1, 17, "interactive",
                  "standard", "batch", "vip", 1.0, b"batch"):
        assert tmsgs.qos_class_of(value) == jmsgs.qos_class_of(value)
    assert tmsgs.QOS_CLASS_NAMES == jmsgs.QOS_CLASS_NAMES
    assert tmsgs.response_to_result(["response", "get", [b"v", 1]],
                                    "get") == [b"v", 1]
    assert tmsgs.response_to_result(["response", "set"], "set") is None
    cases = [
        (["response", "error", "Overloaded", "shed"], "set"),
        (["response", "error", "Mystery", "m"], "get"),
        (["response", "pong"], "get"),
        (["request", "ping"], "pong"),
        ("garbage", "pong"),
    ]
    for resp, kind in cases:
        got = []
        for E, M in ((jerrors, jmsgs), (terrors, tmsgs)):
            with pytest.raises(E.DbeelError) as ei:
                M.response_to_result(resp, kind)
            got.append((ei.value.kind, str(ei.value)))
        assert got[0] == got[1], resp


def test_codec_errors_are_value_errors():
    """The port's codec raises ValueError subclasses where msgpack
    raises its own (also ValueError subclasses): a truncated frame, a
    trailing byte, a non-str map key."""
    good = tmsgs.pack_message(tmsgs.ShardRequest.ping())
    for bad in (good[:-1], good + b"\x00",
                jmsgs.pack_message([{1: 2}])):
        for M in (jmsgs, tmsgs):
            with pytest.raises(ValueError):
                M.unpack_message(bad)


# ---------------------------------------------------------------------
# local_comm
# ---------------------------------------------------------------------


def _local_scenario(L):
    async def main():
        conn = L.LocalShardConnection(3)
        seen = []

        async def shard_loop():
            while True:
                packet = await conn.queue.get()
                seen.append((packet.source_id, packet.message))
                if packet.response_future is not None:
                    packet.response_future.set_result(
                        ["response", "echo", packet.message[1:]]
                    )

        task = asyncio.ensure_future(shard_loop())
        await conn.send_message(1, ["event", "set", "c", b"k", b"v", 5])
        replies = [await conn.send_request(s, ["request", "get", s])
                   for s in range(4)]
        conn.send_stop()
        assert conn.stop_event.is_set()
        task.cancel()
        return conn.id, seen, replies

    return run(main(), timeout=10)


def test_local_shard_connection_agrees():
    assert _local_scenario(tlocal) == _local_scenario(jlocal)
    packet = tlocal.ShardPacket(1, ["x"])
    assert packet.response_future is None


# ---------------------------------------------------------------------
# remote_comm: a loopback shard server (port 0) answering with the
# package's own messages
# ---------------------------------------------------------------------


def _answer(M, msg, store):
    SR, SP = M.ShardRequest, M.ShardResponse
    if msg[0] == "event":
        store.append(msg)
        return None
    kind = msg[1]
    if kind == SR.PING:
        return SP.pong()
    if kind == SR.GET:
        return SP.get((b"v:" + msg[3], len(msg[3])))
    if kind == SR.GET_DIGEST:
        return SP.get_digest((b"v:" + msg[3], -len(msg[3])))
    if kind == SR.MULTI_GET:
        return SP.multi_get([(b"m:" + k, 9) for k in msg[3]])
    if kind == SR.GET_METADATA:
        return SP.get_metadata(
            [M.NodeMetadata("n0", "127.0.0.1", 1, [0], 2, 3)]
        )
    if kind == SR.GET_COLLECTIONS:
        return SP.get_collections([("a", 1), ("b", 2, {"ops_per_sec": 4}),
                                   ("c", 3, None, ["v"])])
    if kind in (SR.SET, SR.DELETE, SR.MULTI_SET):
        store.append(msg)
        return SP.empty(kind)
    return SP.error(M.ProtocolError(f"unknown {kind}"))


async def _loopback(M, gate=None):
    """A persistent multi-message shard server: u32-LE frames in,
    responses strictly in arrival order."""
    store = []

    async def handle(reader, writer):
        try:
            while True:
                size = int.from_bytes(await reader.readexactly(4), "little")
                msg = M.unpack_message(await reader.readexactly(size))
                if gate is not None:
                    await gate.wait()
                resp = _answer(M, msg, store)
                if resp is None:
                    continue
                buf = M.pack_message(resp)
                writer.write(len(buf).to_bytes(4, "little") + buf)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    server = await asyncio.start_server(handle, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    return server, f"127.0.0.1:{port}", store


def _rpc_scenario(pkg):
    E, M, R = PKGS[pkg]

    async def main():
        server, addr, store = await _loopback(M)
        out = {}
        try:
            plain = R.RemoteShardConnection(addr)
            assert not plain.pipeline
            await plain.ping()
            out["metadata"] = [n.to_wire() for n in await plain.get_metadata()]
            out["collections"] = await plain.get_collections()
            await plain.send_event(M.ShardEvent.set("c", b"k", b"v", 7))

            pooled = R.RemoteShardConnection(addr, pooled=True)
            assert pooled.pipeline
            keys = [bytes([i]) * (i % 5 + 1) for i in range(24)]
            replies = await asyncio.gather(*[
                pooled.send_request(M.ShardRequest.get("c", k, qos=2))
                for k in keys
            ])
            assert [r[2][0] for r in replies] == [b"v:" + k for k in keys]
            out["pipelined"] = replies
            out["pipelined_ops"] = pooled.pipelined_ops > 0
            # A MULTI batch over the sub-op cap takes a pooled round trip.
            big = M.ShardRequest.multi_get("c", [b"%d" % i for i in range(300)])
            out["multi"] = await pooled.send_request(big)
            # Byte-matched acks: the raw payload of a packed frame is the
            # reference's constant ack / the predicted digest.
            acks = []
            for frame in (M.ShardRequest.set("c", b"key", b"val", 2**40),
                          M.ShardRequest.get_digest("c", b"abc")):
                buf = M.pack_message(frame)
                acks.append(await pooled.send_packed(
                    len(buf).to_bytes(4, "little") + buf))
            out["acks"] = acks
            assert acks[0] == jmsgs.pack_message(jmsgs.ShardResponse.empty("set"))
            assert acks[1] == jmsgs.pack_message(
                jmsgs.ShardResponse.get_digest((b"v:abc", -3)))
            assert pooled.inflight_ops == pooled.inflight_bytes == 0

            stream = await plain.open_stream()
            await stream.send(M.ShardRequest.ping())
            out["stream"] = await stream.recv()
            stream.close()
            pooled.close_pool()
            # The event rides its own connection: order-free.
            out["store"] = sorted(map(repr, store))
        finally:
            server.close()
            await server.wait_closed()
        return out

    return run(main(), timeout=20)


def test_remote_connection_round_trips_agree():
    assert _rpc_scenario("port") == _rpc_scenario("ref")


def test_no_peer_pipeline_switch(monkeypatch):
    monkeypatch.setenv("DBEEL_NO_PEER_PIPELINE", "1")
    for R in (jremote, tremote):
        assert not R.RemoteShardConnection("127.0.0.1:1", pooled=True).pipeline
    monkeypatch.setenv("DBEEL_NO_PEER_PIPELINE", "0")
    assert tremote.RemoteShardConnection("127.0.0.1:1", pooled=True).pipeline


def _cap_scenario(pkg):
    """Over the per-peer caps the NEWEST send is shed at once with the
    retryable Overloaded; the op in flight keeps its slot and
    completes."""
    E, M, R = PKGS[pkg]

    async def main():
        gate = asyncio.Event()
        server, addr, _ = await _loopback(M, gate)
        try:
            conn = R.RemoteShardConnection(addr, max_inflight_ops=1)
            first = asyncio.ensure_future(conn.ping())
            await asyncio.sleep(0)
            with pytest.raises(E.Overloaded) as ei:
                await conn.ping()
            shed = (conn.shed_count, E.classify_error(ei.value))
            gate.set()
            await first
            assert conn.inflight_ops == 0

            gate.clear()
            conn = R.RemoteShardConnection(
                addr, max_inflight_ops=0, max_inflight_bytes=64)
            buf = M.pack_message(M.ShardRequest.set("c", b"k" * 40, b"", 1))
            framed = len(buf).to_bytes(4, "little") + buf
            first = asyncio.ensure_future(conn.send_packed(framed))
            await asyncio.sleep(0)
            with pytest.raises(E.Overloaded):
                await conn.send_packed(framed)
            gate.set()
            raw = await first
            return shed, conn.shed_count, raw, conn.inflight_bytes
        finally:
            server.close()
            await server.wait_closed()

    return run(main(), timeout=20)


def test_outbound_cap_sheds_newest_first():
    got = _cap_scenario("port")
    assert got == _cap_scenario("ref")
    assert got[0] == (1, "overload") and got[1] == 1 and got[3] == 0


def _fault_scenario(pkg):
    E, M, R = PKGS[pkg]

    async def main():
        server, addr, _ = await _loopback(M)
        out = []
        try:
            conn = R.RemoteShardConnection(addr, read_timeout_ms=30)
            R.set_fault(addr, R.FAULT_REFUSE)
            for call in (conn.ping, lambda: conn.send_event(
                    M.ShardEvent.set("c", b"k", b"v", 1))):
                with pytest.raises(E.ConnectionError_) as ei:
                    await call()
                out.append((ei.value.kind, E.classify_error(ei.value)))
            R.set_fault(addr, R.FAULT_BLACKHOLE)
            with pytest.raises(E.Timeout) as ei:
                await conn.ping()
            out.append((ei.value.kind, E.classify_error(ei.value)))
            pooled = R.RemoteShardConnection(
                addr, read_timeout_ms=30, pooled=True)
            with pytest.raises(E.Timeout):
                await pooled.send_request(M.ShardRequest.get("c", b"k"))
            R.set_fault(addr, ("delay", 0.001))
            out.append(await conn.send_request(M.ShardRequest.ping()))
            R.set_fault(addr, None)
            assert not R._faults
            out.append(await pooled.send_request(M.ShardRequest.get("c", b"k")))
            R.set_fault(addr, R.FAULT_REFUSE)
            R.clear_faults()
            await conn.ping()
            pooled.close_pool()
        finally:
            server.close()
            await server.wait_closed()
        return out

    return run(main(), timeout=20)


def test_fault_seam_refuse_blackhole_delay():
    got = _fault_scenario("port")
    assert got == _fault_scenario("ref")
    assert got[:3] == [("ConnectionError", "coordinator-dead")] * 2 + [
        ("Timeout", "quorum-timeout")]


def test_faults_armed_from_environment(monkeypatch):
    spec = "127.0.0.1:9=refuse,10.0.0.1:7=blackhole,junk,=x,a:1="
    monkeypatch.setenv("DBEEL_REMOTE_FAULTS", spec)
    for R in (jremote, tremote):
        R._arm_from_env()
    assert tremote._faults == jremote._faults == {
        "127.0.0.1:9": "refuse", "10.0.0.1:7": "blackhole"}
    tremote.clear_faults()
    jremote.clear_faults()

    # With a delay the faults arm on a timer thread, after boot.
    import threading

    timers = []

    class FakeTimer:
        def __init__(self, delay, fn):
            timers.append((delay, fn))
            self.daemon = False

        def start(self):
            pass

    monkeypatch.setattr(threading, "Timer", FakeTimer)
    monkeypatch.setenv("DBEEL_REMOTE_FAULTS_DELAY_S", "2.5")
    for R in (jremote, tremote):
        R._arm_from_env()
    assert not tremote._faults and not jremote._faults
    assert [d for d, _ in timers] == [2.5, 2.5]
    for _, fn in timers:
        fn()
    assert tremote._faults == jremote._faults
    assert len(tremote._faults) == 2


# ---------------------------------------------------------------------
# framed: the reference's node-free cases on the port's base
# ---------------------------------------------------------------------


class FakeTransport:
    def __init__(self):
        self.closed = False
        self.paused = 0
        self.resumed = 0
        self.written = []

    def close(self):
        self.closed = True

    def is_closing(self):
        return self.closed

    def pause_reading(self):
        self.paused += 1

    def resume_reading(self):
        self.resumed += 1

    def write(self, data):
        self.written.append(data)


class FakeShard:
    def __init__(self):
        self.tasks = []

    def spawn(self, coro):
        task = asyncio.ensure_future(coro)
        self.tasks.append(task)
        return task


def _scripted(framed_mod):
    class ScriptedProtocol(framed_mod.FramedServerProtocol):
        """4-byte frames; each frame's serve blocks on a gate so tests
        control drain progress; frames starting with b"!" are answered
        on the fast path, b"#" closes it."""

        HEADER = 4
        MAX_FRAME = 1 << 20

        __slots__ = ("served", "gate", "registry", "fast")

        def __init__(self, shard):
            super().__init__(shard)
            self.served = []
            self.fast = []
            self.gate = asyncio.Event()
            self.gate.set()
            self.registry = set()

        def _registry(self):
            return self.registry

        def _try_fast(self, frame):
            if frame.startswith(b"!"):
                self.fast.append(frame)
                self._write_out(b"F" + frame)
                return framed_mod.FAST_HANDLED
            if frame.startswith(b"#"):
                self.fast.append(frame)
                self._write_out(b"bye", close=True)
                return framed_mod.FAST_CLOSE
            return framed_mod.FAST_MISS

        async def _serve_one(self, frame, arrived=0.0):
            await self.gate.wait()
            self.served.append(frame)
            self._write_out(b"S" + frame)
            return True

    return ScriptedProtocol


def _frames32(*payloads):
    return b"".join(len(p).to_bytes(4, "little") + p for p in payloads)


def test_framed_cancelled_drain_does_not_respawn():
    async def main():
        shard = FakeShard()
        p = _scripted(tframed)(shard)
        p.connection_made(FakeTransport())
        p.gate.clear()
        p.data_received(_frames32(b"a", b"b", b"c"))
        (task,) = shard.tasks
        await asyncio.sleep(0)
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass
        assert len(shard.tasks) == 1, "cancelled drain respawned"
        assert p.closing
        assert p.served == []

    run(main(), timeout=10)


def test_framed_backlog_applied_after_oversized_header():
    async def main():
        shard = FakeShard()
        p = _scripted(tframed)(shard)
        t = FakeTransport()
        p.connection_made(t)
        blob = _frames32(b"x", b"y") + (p.MAX_FRAME + 1).to_bytes(
            4, "little") + b"garbage"
        p.data_received(blob)
        assert t.closed, "protocol error must close the transport"
        await asyncio.gather(*shard.tasks)
        assert p.served == [b"x", b"y"]
        assert p.buf == b""

    run(main(), timeout=10)


def test_framed_watermark_pause_resume():
    async def main():
        shard = FakeShard()
        p = _scripted(tframed)(shard)
        t = FakeTransport()
        p.connection_made(t)
        p.gate.clear()
        many = _frames32(*[b"f%d" % i for i in range(p.PENDING_HIGH + 8)])
        p.data_received(many)
        assert t.paused == 1
        p.gate.set()
        await asyncio.gather(*shard.tasks)
        assert t.resumed == 1
        assert len(p.served) == p.PENDING_HIGH + 8

    run(main(), timeout=10)


def _fast_path_scenario(framed_mod):
    """Fast-path frames answer synchronously only while nothing is
    queued; responses leave in arrival order, coalesced into one
    write per loop tick; FAST_CLOSE stops parsing."""

    async def main():
        shard = FakeShard()
        p = _scripted(framed_mod)(shard)
        t = FakeTransport()
        p.connection_made(t)
        assert p in p.registry
        p.data_received(_frames32(b"!1", b"!2"))
        p.gate.clear()
        # A slow frame queues; the fast frame behind it must wait, in
        # the same read and in a later one (split mid-frame).
        p.data_received(_frames32(b"s1", b"!3"))
        p.data_received(_frames32(b"s2")[:3])
        p.data_received(_frames32(b"s2")[3:])
        await asyncio.sleep(0)
        p.gate.set()
        await asyncio.gather(*shard.tasks)
        await asyncio.sleep(0)
        p.data_received(_frames32(b"!4", b"#5", b"!6"))
        await asyncio.sleep(0)
        p.connection_lost(None)
        return (p.fast, p.served, t.written, t.closed, bool(p.registry),
                bytes(p.buf))

    return run(main(), timeout=10)


def test_framed_fast_path_order_agrees():
    got = _fast_path_scenario(tframed)
    assert got == _fast_path_scenario(jframed)
    assert got[0] == [b"!1", b"!2", b"!4", b"#5"]
    assert got[1] == [b"s1", b"!3", b"s2"]


def test_framed_u16_header_and_aimd_window():
    class Gov:
        def __init__(self):
            self.soft = True
            self.notes = []

        def soft_overloaded(self):
            return self.soft

        def note_window(self, w, dec):
            self.notes.append((w, dec))

    def scenario(framed_mod):
        class P16(framed_mod.FramedServerProtocol):
            HEADER = 2
            MAX_FRAME = None

            def _registry(self):
                return set()

            async def _serve_one(self, frame, arrived=0.0):
                return True

        shard = FakeShard()
        shard.governor = Gov()
        p = P16(shard)
        p.window = 32.0
        trail = []
        for i in range(80):
            if i == 40:
                shard.governor.soft = False
            p.aimd_tick(2.0, 32.0)
            trail.append(round(p.window, 9))
        return trail, shard.governor.notes

    got = scenario(tframed)
    assert got == scenario(jframed)
    assert min(got[0]) == 2.0 and got[0][-1] > 2.0
