"""The port's Kafka wire protocol against the reference's.

The cases of ``tests/test_kafka_protocol.py`` on the port's copy
(``kafka/kafka_protocol.py``): the MessageSet v0 codec round-trips,
ignores a partial trailing message and checks CRCs; the protocol client
speaks ApiVersions, Metadata, ListOffsets, Produce and Fetch; a
``KafkaReplayLog`` is a shard's log (append, read, resume, retention,
tombstones, separate producer and consumer connections). Each client
runs against the other package's ``FakeKafkaBroker`` as well as its own,
and the codec's bytes equal the reference's over seeded inputs.
Containers read back are the bytes appended. Every call has a deadline:
the clients' socket timeout.
"""

from __future__ import annotations

import numpy as np
import pytest

from filodb_tpu.kafka import kafka_protocol as ref_kp
from filodb_tpu.testing.data import gauge_stream, machine_metrics_series
from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.core.record import BytesContainer
from filodb_tpu_torch.core.store.config import StoreConfig
from filodb_tpu_torch.kafka import kafka_protocol as port_kp

START = 1_600_000_000
TOPIC = "timeseries-dev"
PKG = {"port": port_kp, "ref": ref_kp}
# (broker's package, client's package)
COMBOS = [("port", "port"), ("port", "ref"), ("ref", "port")]


@pytest.fixture(params=COMBOS, ids=lambda c: f"{c[0]}broker-{c[1]}client")
def env(request):
    b_pkg, c_pkg = request.param
    broker = PKG[b_pkg].FakeKafkaBroker().start()
    broker.create_topic(TOPIC, 4)
    yield broker, PKG[c_pkg]
    broker.stop()


@pytest.fixture
def client(env):
    broker, pkg = env
    c = pkg.KafkaProtocolClient("127.0.0.1", broker.port)
    yield c
    c.close()


def _stream(n_keys, n, batch):
    return [sd.container.serialize() for sd in gauge_stream(
        machine_metrics_series(n_keys), n, start_ms=START * 1000,
        batch=batch)]


class TestMessageSet:
    def test_round_trip(self):
        entries = [(0, b"k0", b"v0"), (1, None, b"v1"), (2, b"k2", b"")]
        out = port_kp.decode_message_set(port_kp.encode_message_set(entries))
        assert out == entries

    def test_partial_trailing_message_ignored(self):
        data = port_kp.encode_message_set([(0, None, b"hello")])
        assert port_kp.decode_message_set(data[:-3]) == []

    def test_crc_mismatch_raises(self):
        data = bytearray(port_kp.encode_message_set([(0, None, b"hello")]))
        data[-1] ^= 0xFF
        with pytest.raises(ValueError, match="crc"):
            port_kp.decode_message_set(bytes(data))

    @pytest.mark.parametrize("seed", range(4))
    def test_codec_bytes_are_the_references(self, seed):
        rng = np.random.default_rng(seed)
        entries = []
        for i in range(int(rng.integers(1, 40))):
            key = None if rng.random() < 0.3 else \
                rng.bytes(int(rng.integers(0, 20)))
            value = None if rng.random() < 0.1 else \
                rng.bytes(int(rng.integers(0, 3000)))
            entries.append((int(rng.integers(0, 2**40)) + i, key, value))
        mine = port_kp.encode_message_set(entries)
        assert mine == ref_kp.encode_message_set(entries)
        for _, k, v in entries:
            assert port_kp.encode_message(k, v) == ref_kp.encode_message(k, v)
        cut = int(rng.integers(0, len(mine)))
        assert port_kp.decode_message_set(mine[:cut]) == \
            ref_kp.decode_message_set(mine[:cut])
        assert port_kp.decode_message_set(mine) == entries


class TestProtocolClient:
    def test_api_versions(self, client):
        vers = client.api_versions()
        assert 0 in vers and 1 in vers and 2 in vers and 3 in vers

    def test_metadata(self, client, env):
        broker, _ = env
        md = client.metadata([TOPIC])
        assert md["brokers"][0][2] == broker.port
        parts = md["topics"][TOPIC]["partitions"]
        assert sorted(parts) == [0, 1, 2, 3]

    def test_produce_fetch_offsets(self, client):
        base = client.produce(TOPIC, 1, [(None, b"m0"), (b"key", b"m1")])
        assert base == 0
        assert client.produce(TOPIC, 1, [(None, b"m2")]) == 2
        hw, msgs = client.fetch(TOPIC, 1, 0)
        assert hw == 3
        assert [v for _, _, v in msgs] == [b"m0", b"m1", b"m2"]
        assert msgs[1][1] == b"key"
        assert client.list_offsets(TOPIC, 1, -2) == 0  # earliest
        assert client.list_offsets(TOPIC, 1, -1) == 3  # latest

    def test_fetch_from_mid_offset(self, client):
        client.produce(TOPIC, 0, [(None, f"m{i}".encode())
                                  for i in range(10)])
        hw, msgs = client.fetch(TOPIC, 0, 7)
        assert [o for o, _, _ in msgs] == [7, 8, 9]

    def test_fetch_out_of_range(self, client, env):
        _, pkg = env
        client.produce(TOPIC, 2, [(None, b"x")])
        with pytest.raises(pkg.KafkaProtocolError):
            client.fetch(TOPIC, 2, 99)

    def test_fetch_respects_max_bytes(self, client):
        client.produce(TOPIC, 3, [(None, bytes(1000)) for _ in range(20)])
        _, msgs = client.fetch(TOPIC, 3, 0, max_bytes=3000)
        assert 1 <= len(msgs) < 20

    def test_unknown_topic(self, client, env):
        _, pkg = env
        with pytest.raises(pkg.KafkaProtocolError):
            client.fetch("nope", 0, 0)


class TestKafkaReplayLog:
    def test_append_read_latest(self, env):
        broker, pkg = env
        lg = pkg.KafkaReplayLog("127.0.0.1", broker.port, TOPIC, 0)
        raws = _stream(2, 40, 10)
        offs = [lg.append(BytesContainer(r)) for r in raws]
        assert offs == list(range(len(raws)))
        assert lg.latest_offset == len(raws) - 1
        got = list(lg.read_from(0))
        assert [sd.offset for sd in got] == offs
        # containers round-trip through the broker byte-exactly
        assert [sd.container.serialize() for sd in got] == raws
        assert [sd.offset for sd in lg.read_from(5)] == offs[5:]
        lg.close()

    def test_retention_truncation_skips_forward(self, env):
        broker, pkg = env
        lg = pkg.KafkaReplayLog("127.0.0.1", broker.port, TOPIC, 1)
        for r in _stream(1, 30, 10):
            lg.append(BytesContainer(r))
        broker.truncate_before(TOPIC, 1, 2)
        got = list(lg.read_from(0))  # head truncated: resume at earliest
        assert [sd.offset for sd in got] == [2]
        lg.close()

    def test_shard_ingests_from_kafka(self, env):
        """A port shard consumes container bytes from the broker exactly
        as from any other log (partition == shard)."""
        broker, pkg = env
        lg = pkg.KafkaReplayLog("127.0.0.1", broker.port, TOPIC, 2)
        for r in _stream(4, 100, 25):
            lg.append(BytesContainer(r))
        ms = MemStore(1, 0, config=StoreConfig(max_chunk_size=50))
        shard = ms.shards[0]
        reader = port_kp.KafkaReplayLog("127.0.0.1", broker.port, TOPIC, 2)
        for sd in reader.read_from(0):
            shard.ingest(sd)
        reader.close()
        assert shard.stats.rows_ingested.value == 400
        assert shard.latest_offset == lg.latest_offset
        assert shard.num_partitions == 4
        lg.close()


class TestReviewRegressions:
    def test_tombstone_does_not_wedge_read(self, env, client):
        """A null-value (tombstone) message advances the cursor."""
        broker, pkg = env
        client.produce(TOPIC, 0, [(None, b"a")])
        client.produce(TOPIC, 0, [(b"k", None)])  # tombstone
        client.produce(TOPIC, 0, [(None, b"b")])
        lg = pkg.KafkaReplayLog("127.0.0.1", broker.port, TOPIC, 0)
        assert [sd.offset for sd in lg.read_from(0)] == [0, 2]
        lg.close()

    def test_missing_topic_is_log_op_error(self, env):
        """Deterministic broker answers surface as the client package's
        LogOpError, not as retryable transport errors."""
        broker, pkg = env
        lg = pkg.KafkaReplayLog("127.0.0.1", broker.port, "no-such-topic", 0)
        with pytest.raises(pkg.LogOpError):
            list(lg.read_from(0))
        lg.close()

    def test_producer_consumer_use_separate_connections(self, env):
        broker, pkg = env
        lg = pkg.KafkaReplayLog("127.0.0.1", broker.port, TOPIC, 1)
        lg.append(BytesContainer(b"\x02" + b"\x00" * 4))  # empty v2
        assert lg.client is not lg._consumer
        lg.close()
