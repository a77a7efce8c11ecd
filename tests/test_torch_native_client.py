"""dbeel_tpu_torch.client.native_client — the C smart client's binding —
on port nodes.

The reference's tests/test_native_client.py cases run against a port
node (tests/torch_shards.py ``Node``, two shards, on the CPU) in this
process, with the port's ``NativeDbeelClient`` called from a worker
thread: the client blocks, and the node serves on the loop meanwhile.
Then the pipelined train, the batched ops, CAS, QoS and trace stamping
and the admin reads; the 24 ``dbeel_cli_*`` prototypes equal to the
reference's binding; and a library lacking any one of them refused by
``storage.native.load()``.
"""

import asyncio
import ctypes
import time

import msgpack
import pytest

from dbeel_tpu.client import native_client as jnative_client
from dbeel_tpu.storage import native as jnative
from dbeel_tpu_torch import errors as terrors
from dbeel_tpu_torch.client import DbeelClient
from dbeel_tpu_torch.client import native_client
from dbeel_tpu_torch.storage import native as tnative
from dbeel_tpu_torch.utils.murmur import hash_bytes, hash_string

from torch_shards import Node, no_leftovers, node_config, run  # noqa: F401

# Every symbol of the C client (native/src/dbeel_client.cpp exports
# these 24 and no other dbeel_cli_*).
CLI_SYMBOLS = sorted(n for n in tnative._PROTOTYPES
                     if n.startswith("dbeel_cli_"))


@pytest.fixture
def built():
    if tnative.load() is None or not native_client.available():
        pytest.skip("native library cannot be built")


def with_node(tmp_path, fn, n_shards=2):
    """``fn(node)`` in a worker thread while a port node serves on the
    loop; returns what it returned."""

    async def main():
        node = await Node("port", node_config(
            "port", str(tmp_path / "db")), n_shards=n_shards).start()
        node.loop = asyncio.get_running_loop()
        try:
            return await asyncio.to_thread(fn, node)
        finally:
            await node.stop()

    return run(main(), timeout=60)


def _client(node):
    return native_client.NativeDbeelClient("127.0.0.1", node.config.port)


# ---------------------------------------------------------------------
# The reference's cases
# ---------------------------------------------------------------------


def test_native_client_end_to_end(tmp_path, built):
    def drive(node):
        with _client(node) as cli:
            # Two shards on one node -> two ring points.
            assert cli.ring_size == 2
            cli.create_collection("nc", replication_factor=1)
            time.sleep(0.3)  # local fan-out to shard 1
            values = {
                "a": 1,
                "b": "text",
                "c": {"nested": [1, 2, 3]},
                "d": None,
                **{f"k{i}": i for i in range(40)},
            }
            for k, v in values.items():
                cli.set("nc", k, v)
            for k, v in values.items():
                assert cli.get("nc", k) == v
            cli.delete("nc", "a")
            with pytest.raises(terrors.KeyNotFound):
                cli.get("nc", "a")
            with pytest.raises(terrors.KeyNotFound):
                cli.get("nc", "never-written")

    with_node(tmp_path, drive)


def test_native_client_routing_matches_python_ring(tmp_path, built):
    """The C replica walk routes exactly like the port's Python client:
    each key the C client sets lands in the tree of the shard the Python
    ring names, and the ring's hashes are the node's shard names'."""

    def drive(node):
        with _client(node) as cli:
            assert cli.ring_size == 2
            cli.create_collection("rt", replication_factor=1)
            time.sleep(0.3)
            for i in range(64):
                cli.set("rt", f"route{i}", i)
                assert cli.get("rt", f"route{i}") == i

    with_node(tmp_path, lambda node: (drive(node), _owners(node))[1])


def _owners(node):
    hashes = sorted(hash_string(f"n0-{sid}") for sid in (0, 1))
    assert len(set(hashes)) == 2

    async def py_ring():
        c = await DbeelClient.from_seed_nodes([node.db_address])
        c.close()
        return c

    c = asyncio.run_coroutine_threadsafe(py_ring(), node.loop).result(10)
    assert sorted(s.hash for s in c._ring) == hashes
    by_port = {node.config.port + i: s for i, s in enumerate(node.shards)}
    for i in range(64):
        key = msgpack.packb(f"route{i}", use_bin_type=True)
        owner = c._shards_for_key(hash_bytes(key), 1)[0]
        for port, shard in by_port.items():
            held = asyncio.run_coroutine_threadsafe(
                shard.collections["rt"].tree.get(key), node.loop).result(10)
            assert (held is not None) == (port == owner.db_port), i


def test_native_client_latency_yardstick(tmp_path, built):
    def drive(node):
        with _client(node) as cli:
            cli.create_collection("lat", replication_factor=1)
            time.sleep(0.3)
            cli.set("lat", "warm", 1)
            t0 = time.perf_counter()
            n = 200
            for i in range(n):
                cli.set("lat", "warm", i)
            per_op = (time.perf_counter() - t0) / n
            assert per_op < 0.05, f"set round trip {per_op * 1e6:.0f}us"

    with_node(tmp_path, drive)


def test_native_client_large_value_grows_buffer(tmp_path, built):
    def drive(node):
        with _client(node) as cli:
            cli.create_collection("big", replication_factor=1)
            time.sleep(0.3)
            big = "x" * 4096
            cli.set("big", "k", big)
            cli._buf = (ctypes.c_uint8 * 16)()  # force the -10 grow path
            assert cli.get("big", "k") == big
            assert len(cli._buf) >= 4096  # grown to the reported size
            # An oversized SET is rejected loudly by the frame bound; the
            # walk retries it until its deadline, here 0.5 s (the
            # default is 10 s).
            cli.set_retry(op_deadline_ms=500)
            with pytest.raises(terrors.DbeelError, match="frame too large"):
                cli.set("big", "k2", "x" * 70000)

    with_node(tmp_path, drive)


def test_native_client_scan_and_count(tmp_path, built):
    def drive(node):
        with _client(node) as cli:
            cli.create_collection("sc", replication_factor=1)
            time.sleep(0.3)
            items = {f"key-{i:04d}": {"v": i} for i in range(150)}
            cli.multi_set("sc", items)
            cli.delete("sc", "key-0003")
            got = cli.scan("sc")
            assert [k for k, _v in got] == sorted(
                k for k in items if k != "key-0003")
            assert all(v == items[k] for k, v in got)
            assert cli.count("sc") == 149
            pfx = msgpack.packb("key-0000")[:7]
            assert cli.count("sc", prefix=pfx) == 99
            assert [k for k, _v in cli.scan("sc", prefix=pfx)] == sorted(
                f"key-{i:04d}" for i in range(100) if i != 3)
            assert cli.scan("sc", max_bytes=512) == got
            flt = ["and", ["cmp", "v", ">=", 10], ["cmp", "v", "<", 30]]
            assert [k for k, _v in cli.scan("sc", filter=flt)] == [
                f"key-{i:04d}" for i in range(10, 30)]
            assert cli.count("sc", filter=["cmp", "v", "<", 10]) == 9
            assert cli.count(
                "sc", aggregate={"op": "sum", "field": "v"}
            ) == sum(i for i in range(150) if i != 3)
            assert cli.count(
                "sc", aggregate={"op": "max", "field": "v"},
                filter=["cmp", "v", "<", 100]) == 99
            stats = cli.get_stats()
            assert set(stats["scan"]["filter"]) >= {
                "specs_served", "rows_scanned", "rows_returned",
                "bytes_saved", "agg_partials", "device_evals",
                "fallback_evals"}

    with_node(tmp_path, drive)


# ---------------------------------------------------------------------
# The rest of the binding
# ---------------------------------------------------------------------


def test_native_client_pipe_multi_and_cas(tmp_path, built):
    def drive(node):
        with _client(node) as cli:
            assert cli.set_retry(op_deadline_ms=5000, backoff_base_ms=10,
                                 backoff_cap_ms=100) is True
            cli.create_collection("p", replication_factor=1)
            time.sleep(0.3)
            for i in range(50):
                cli.pipe_set("p", f"t{i}", {"i": i}, window=8)
            assert cli.pipe_drain() == 0
            for i in range(50):
                cli.pipe_get("p", f"t{i}", window=8)
            cli.pipe_get("p", "absent", window=8)
            assert cli.pipe_drain() == 1  # the absent key
            keys = [f"r{i}" for i in range(300)]
            assert cli.pipe_run("p", "set", keys, list(range(300)),
                                window=16) == 0
            assert cli.pipe_run("p", "get", keys + ["absent"]) == 1
            assert cli.pipe_run("p", "get", []) == 0
            assert cli.multi_get("p", keys[:5] + ["absent"]) == [
                0, 1, 2, 3, 4, None]
            cli.multi_set("p", [(f"m{i}", [i, str(i)]) for i in range(200)])
            cli.multi_set("p", {})
            assert cli.multi_get("p", [f"m{i}" for i in range(200)]) == [
                [i, str(i)] for i in range(200)]
            assert cli.multi_get("p", []) == []
            assert cli.get("p", "t7") == {"i": 7}
            # CAS: a conflict leaves the value, the expectation that
            # holds commits, then a conditional delete and an absent key.
            assert cli.cas("p", "t7", 70, expect_value={"i": 8}) is False
            assert cli.get("p", "t7") == {"i": 7}
            assert cli.cas("p", "t7", 70, expect_value={"i": 7}) is True
            assert cli.get("p", "t7") == 70
            assert cli.cas("p", "new", 1, expect_absent=True) is True
            assert cli.cas("p", "new", 2, expect_absent=True) is False
            assert cli.cas("p", "new", delete=True, expect_value=1) is True
            with pytest.raises(terrors.KeyNotFound):
                cli.get("p", "new")
            cli.create_collection("ix", replication_factor=1,
                                  index=["v", "w"])
            with pytest.raises(terrors.DbeelError):
                cli.create_collection("ix", replication_factor=1)
            cli.sync_metadata()
            assert cli.ring_size == 2

    with_node(tmp_path, drive)


def test_native_client_qos_trace_and_stats(tmp_path, built):
    def drive(node):
        port = node.config.port
        with _client(node) as cli:
            cli.create_collection("q", replication_factor=1)
            time.sleep(0.3)
            assert cli.set_qos("batch", "tenant-a") is True
            for i in range(20):
                cli.set("q", f"k{i}", i)
            assert cli.set_qos(None, None) is True
            assert cli.set_trace(777001) is True
            cli.set("q", "traced", {"v": 1})
            assert cli.set_trace(0) is True
            stats = [cli.get_stats("127.0.0.1", port + i) for i in (0, 1)]
            assert [s["shard"] for s in stats] == ["n0-0", "n0-1"]
            assert cli.get_stats()["shard"] == "n0-0"
            assert sum(s["qos"]["classes"]["batch"]["admitted"]
                       for s in stats) == 20
            assert sum(s["qos"]["tenants"]["tenant-a"]["ops"]
                       for s in stats if "tenant-a" in s["qos"]["tenants"]
                       ) == 20
            assert all(s["collections"]["q"]["strategy"] == "heap"
                       for s in stats)
            dumps = [cli.trace_dump("127.0.0.1", port + i) for i in (0, 1)]
            spans = [e for d in dumps for e in d["entries"]
                     if e.get("trace_id") == 777001]
            assert len(spans) == 1 and spans[0]["op"] == "set"
            assert spans[0]["client_stamped"] is True
            health = cli.cluster_stats()
            assert {"nodes", "missing"} <= set(health)

    with_node(tmp_path, drive)


def test_native_client_refuses_a_dead_seed(built):
    """No node at the seed: the constructor raises, nothing leaks."""
    with pytest.raises(ConnectionError):
        native_client.NativeDbeelClient("127.0.0.1", 1)


# ---------------------------------------------------------------------
# The binding itself
# ---------------------------------------------------------------------


def test_the_client_symbols_are_the_sources():
    """The prototypes name exactly the C client's exports."""
    import re

    with open(tnative._NATIVE_DIR + "/src/dbeel_client.cpp") as f:
        exported = set(re.findall(r"dbeel_cli_[a-z_0-9]*", f.read()))
    assert exported == set(CLI_SYMBOLS) and len(CLI_SYMBOLS) == 24


@pytest.fixture(scope="module")
def ref_bound():
    lib = jnative._load()
    if lib is None:
        pytest.skip("native library cannot be built")
    jnative_client._bind(lib)
    return lib


@pytest.mark.parametrize("symbol", CLI_SYMBOLS)
def test_client_prototype_equals_reference(ref_bound, symbol):
    restype, argtypes = tnative._PROTOTYPES[symbol]
    fn = getattr(ref_bound, symbol)
    assert restype is fn.restype or (restype is None and fn.restype is None)
    assert list(argtypes) == list(fn.argtypes)
    port_fn = getattr(tnative.load(), symbol)
    assert port_fn.restype is fn.restype
    assert list(port_fn.argtypes) == list(fn.argtypes)


class _Lacking:
    """A loaded library without one symbol."""

    def __init__(self, lib, missing):
        self._lib, self._missing = lib, missing

    def __getattr__(self, name):
        if name == self._missing:
            raise AttributeError(name)
        return getattr(self._lib, name)


@pytest.mark.parametrize("symbol", CLI_SYMBOLS)
def test_library_lacking_a_client_symbol_is_refused(monkeypatch, built,
                                                    symbol):
    """``load()`` does not use a library without ``symbol``: the client
    is then unavailable and its constructor raises the build's
    message."""
    real_cdll = ctypes.CDLL
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    monkeypatch.setattr(tnative, "_stale", lambda: False)
    monkeypatch.setattr(tnative, "LIB_OVERRIDDEN", False)
    monkeypatch.setattr(
        tnative.ctypes, "CDLL",
        lambda path: _Lacking(real_cdll(path), symbol))
    assert tnative.load() is None
    assert not native_client.available()
    with pytest.raises(RuntimeError, match="make -C native"):
        native_client.NativeDbeelClient("127.0.0.1", 1)


def test_available_is_load_if_built(monkeypatch):
    assert native_client.available() == (tnative.load_if_built() is not None)
    monkeypatch.setattr(tnative, "load_if_built", lambda: None)
    assert native_client.available() is False
