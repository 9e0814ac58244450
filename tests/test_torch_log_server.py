"""The port's networked ingest log against the reference's.

The cases of ``tests/test_log_server.py``, each run with the server of
one package and the client of the other as well as the port's with its
own (``kafka/log_server.py``): a ``RemoteLog`` appends, reads back,
tails from an offset in batches, keeps its log across a server restart,
truncates and aligns, authenticates, and the broker rejects names that
would leave its root. Containers read back must be the bytes appended.
A port cluster ingests through remote handles from either package's
broker, with its gateway sink producing to it, and answers as the store
holding every sample. Every call has a deadline: the clients' socket
timeout and the tests' own loops.
"""

from __future__ import annotations

import time

import pytest

from filodb_tpu.kafka import log_server as ref_ls
from filodb_tpu.testing.data import gauge_stream, machine_metrics_series
from filodb_tpu_torch.core.record import BytesContainer, parse_container
from filodb_tpu_torch.kafka import log_server as port_ls

PKG = {"port": port_ls, "ref": ref_ls}
# (server's package, client's package)
COMBOS = [("port", "port"), ("port", "ref"), ("ref", "port")]


@pytest.fixture(params=COMBOS, ids=lambda c: f"{c[0]}server-{c[1]}client")
def env(request, tmp_path):
    srv_pkg, cli_pkg = request.param
    srv = PKG[srv_pkg].LogServer(str(tmp_path / "broker")).start()
    yield srv, PKG[srv_pkg], PKG[cli_pkg]
    srv.stop()


def containers(n, start_ms=0) -> list[bytes]:
    keys = machine_metrics_series(1)
    return [sd.container.serialize()
            for sd in gauge_stream(keys, n, batch=1, start_ms=start_ms)]


def _put(lg, raw: bytes) -> int:
    return lg.append(BytesContainer(raw))


class TestRemoteLog:
    def test_append_read_round_trip(self, env):
        srv, _, cli = env
        lg = cli.RemoteLog("127.0.0.1", srv.port, "ds", 0)
        raws = containers(10)
        for i, raw in enumerate(raws):
            assert _put(lg, raw) == i
        assert lg.latest_offset == 9
        entries = list(lg.read_from(0))
        assert [e.offset for e in entries] == list(range(10))
        # the bytes appended come back, and parse into records
        assert [e.container.serialize() for e in entries] == raws
        assert parse_container(entries[0].container.serialize()).ts[0] == 0
        lg.close()

    def test_partition_isolation(self, env):
        srv, _, cli = env
        l0 = cli.RemoteLog("127.0.0.1", srv.port, "ds", 0)
        l1 = cli.RemoteLog("127.0.0.1", srv.port, "ds", 1)
        for raw in containers(3):
            _put(l0, raw)
        assert l1.latest_offset == -1
        assert list(l1.read_from(0)) == []
        l0.close()
        l1.close()

    def test_tail_from_offset_and_batching(self, env):
        srv, _, cli = env
        lg = cli.RemoteLog("127.0.0.1", srv.port, "ds", 0, read_batch=4)
        for raw in containers(11):
            _put(lg, raw)
        assert [e.offset for e in lg.read_from(5)] == [5, 6, 7, 8, 9, 10]
        lg.close()

    def test_durability_across_server_restart(self, env, tmp_path):
        srv, spkg, cli = env
        lg = cli.RemoteLog("127.0.0.1", srv.port, "ds", 0)
        raws = containers(6)
        for raw in raws:
            _put(lg, raw)
        lg.close()
        srv.stop()
        srv2 = spkg.LogServer(str(tmp_path / "broker")).start()
        try:
            lg2 = cli.RemoteLog("127.0.0.1", srv2.port, "ds", 0)
            assert lg2.latest_offset == 5
            assert [e.container.serialize()
                    for e in lg2.read_from(0)] == raws
            # truncation + offset alignment work remotely
            assert lg2.truncate_before(10) == 0  # single segment retained
            lg2.align_after(100)
            assert _put(lg2, containers(1, start_ms=10**9)[0]) == 101
            lg2.close()
        finally:
            srv2.stop()

    def test_auth_required(self, env, tmp_path, monkeypatch):
        _, spkg, cli = env
        srv = spkg.LogServer(str(tmp_path / "b2"),
                             secret="brokersecret").start()
        try:
            lg = cli.RemoteLog("127.0.0.1", srv.port, "ds", 0)
            with pytest.raises((ConnectionError, RuntimeError, OSError)):
                _put(lg, containers(1)[0])
            monkeypatch.setenv("FILODB_CLUSTER_SECRET", "brokersecret")
            lg2 = cli.RemoteLog("127.0.0.1", srv.port, "ds", 0)
            assert _put(lg2, containers(1)[0]) == 0
            lg2.close()
        finally:
            srv.stop()


class TestClusterOverNetworkedLog:
    @pytest.mark.parametrize("broker", ["port", "ref"])
    def test_gateway_and_owner_without_shared_fs(self, broker, tmp_path):
        """A port cluster against a broker: the gateway sink produces to
        the log server through remote handles of its own; the shard's
        ingest worker tails it remotely."""
        from filodb_tpu_torch.coordinator.cluster import FilodbCluster, Node
        from filodb_tpu_torch.core.store.config import (
            IngestionConfig,
            StoreConfig,
        )
        from filodb_tpu_torch.gateway.influx import parse_influx_line
        from filodb_tpu_torch.gateway.server import ContainerSink

        srv = PKG[broker].LogServer(str(tmp_path / "broker")).start()
        cluster = FilodbCluster()
        try:
            num_shards = 2
            cluster.join(Node("n0"))
            logs = {s: port_ls.RemoteLog("127.0.0.1", srv.port, "ts", s)
                    for s in range(num_shards)}
            cfg = IngestionConfig(dataset="ts", num_shards=num_shards,
                                  store=StoreConfig(max_chunk_size=100,
                                                    groups_per_shard=2))
            cluster.setup_dataset(cfg, logs)
            sink_logs = {s: port_ls.RemoteLog("127.0.0.1", srv.port, "ts",
                                              s)
                         for s in range(num_shards)}
            sink = ContainerSink(sink_logs, num_shards, spread=1,
                                 dataset="ts")
            for i in range(50):
                for app in ("a", "b", "c"):
                    sink.add(parse_influx_line(
                        f"m_net,app={app} value={i} "
                        f"{(1_600_000_000 + i * 10) * 10**9}"))
            sink.flush()
            svc = cluster.query_service("ts", device="cpu")
            t = 1_600_000_000 + 500
            count = total = None
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                count = svc.query_range("count(m_net)", t, 60, t)
                total = svc.query_range("sum(count_over_time(m_net[1d]))",
                                        t, 60, t)
                if count.result.values.size and \
                        count.result.values[0, 0] == 3 and \
                        total.result.values[0, 0] == 150:
                    break
                time.sleep(0.05)
            assert count.result.values[0, 0] == 3
            assert total.result.values[0, 0] == 150
            for lg in (*logs.values(), *sink_logs.values()):
                lg.close()
        finally:
            cluster.stop()
            srv.stop()


class TestWireValidation:
    """Wire-supplied dataset/shard become filesystem path components; the
    broker rejects anything that could escape its root."""

    def test_path_traversal_dataset_rejected(self, env, tmp_path):
        srv, _, cli = env
        lg = cli.RemoteLog("127.0.0.1", srv.port, "../../evil", 0)
        with pytest.raises(cli.LogOpError, match="invalid dataset"):
            _put(lg, containers(1)[0])
        # nothing escaped the broker root
        assert not (tmp_path / "evil").exists()
        lg.close()

    def test_bad_shard_types_rejected(self, env):
        srv, _, cli = env
        for bad in ("0/../..", -1, 10**9, True):
            lg = cli.RemoteLog("127.0.0.1", srv.port, "ds", bad)
            with pytest.raises(cli.LogOpError, match="invalid shard"):
                lg.latest_offset
            lg.close()

    def test_slash_and_dot_names_rejected(self, env):
        srv, _, cli = env
        for bad in ("a/b", "..", ".", "", "x" * 200):
            lg = cli.RemoteLog("127.0.0.1", srv.port, bad, 0)
            with pytest.raises(cli.LogOpError, match="invalid dataset"):
                lg.latest_offset
            lg.close()

    def test_server_error_is_log_op_error_not_transport(self, env):
        """Deterministic server-side errors raise LogOpError (a RuntimeError
        subclass), so retry loops can tell them from transport failures."""
        srv, _, cli = env
        lg = cli.RemoteLog("127.0.0.1", srv.port, "../../x", 3)
        with pytest.raises(cli.LogOpError) as e:
            lg.latest_offset
        assert isinstance(e.value, RuntimeError)
        lg.close()

    def test_valid_names_still_work(self, env):
        srv, _, cli = env
        lg = cli.RemoteLog("127.0.0.1", srv.port, "prod-metrics_v2.1", 42)
        assert _put(lg, containers(1)[0]) == 0
        assert lg.latest_offset == 0
        lg.close()

    def test_newline_dataset_rejected(self, env):
        srv, _, cli = env
        lg = cli.RemoteLog("127.0.0.1", srv.port, "evil\n", 0)
        with pytest.raises(cli.LogOpError, match="invalid dataset"):
            lg.latest_offset
        lg.close()

    def test_read_batch_capped(self, env):
        """A huge max_n must not make the broker materialize the whole log
        in one reply."""
        srv, _, cli = env
        lg = cli.RemoteLog("127.0.0.1", srv.port, "ds", 7)
        for raw in containers(3):
            _put(lg, raw)
        batch = lg._call("read", "ds", 7, 0, 10**18)
        assert len(batch) == 3  # served, but the cap bounds any reply
        assert cli.MAX_READ_BATCH >= 256  # sane floor for real tailing
        assert lg._call("read", "ds", 7, 0, -5) == []
        with pytest.raises(cli.LogOpError, match="invalid read"):
            lg._call("read", "ds", 7, "zero", 10)
        lg.close()

    def test_client_read_batch_clamped_to_server_cap(self, env):
        """A client read_batch above the broker cap must not break
        end-of-log detection (short-batch sentinel)."""
        srv, _, cli = env
        lg = cli.RemoteLog("127.0.0.1", srv.port, "ds", 9,
                           read_batch=cli.MAX_READ_BATCH * 2)
        assert lg.read_batch == cli.MAX_READ_BATCH
        for raw in containers(5):
            _put(lg, raw)
        assert len(list(lg.read_from(0))) == 5
        lg.close()


def test_the_ports_constants_are_the_references():
    assert port_ls.MAX_READ_BATCH == ref_ls.MAX_READ_BATCH
    assert port_ls._SAFE_NAME.pattern == ref_ls._SAFE_NAME.pattern


@pytest.mark.parametrize("server", ["log", "store"])
def test_the_servers_answer_without_nagles_delay(server, tmp_path):
    """An accepted connection sends without Nagle's delay: a reply's body
    goes out behind its length at once instead of after the client's
    delayed ACK (40 ms a request)."""
    import socket

    from filodb_tpu_torch.core.store.remotestore import ChunkStoreServer

    srv = port_ls.LogServer(str(tmp_path)) if server == "log" \
        else ChunkStoreServer(root=str(tmp_path))
    try:
        with socket.create_connection(("127.0.0.1", srv.port),
                                      timeout=10):
            conn, _ = srv.server.get_request()
            try:
                assert conn.getsockopt(socket.IPPROTO_TCP,
                                       socket.TCP_NODELAY)
            finally:
                conn.close()
    finally:
        srv.server.server_close()
