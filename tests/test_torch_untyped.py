"""Port parity for the ``untyped`` schema (ROADMAP §C.12).

The reference registers ``untyped`` (a gauge's columns, no downsamplers);
the port lacked it, so its C++ ingest pass dropped ``untyped`` records
without an error and a directory with an ``untyped`` partition failed to
recover. One set of containers, half ``untyped`` and half ``gauge``
samples (values made from a seed with numpy), goes into both packages:

- the port ingests every record, as the reference does, and answers the
  ``untyped`` series on both engines as every reference lane does, within
  the parity tests' tolerance;
- a directory the reference flushed recovers in the port, and a directory
  the port flushed recovers in the reference, with the same answers;
- an index snapshot carries ``untyped`` partitions either way;
- the downsampler job skips ``untyped``, as the reference's job does.
"""

from __future__ import annotations

import numpy as np
import pytest

from filodb_tpu.core.partkey import PartKey as RefPartKey
from filodb_tpu.core.record import IngestRecord as RefRecord
from filodb_tpu.core.record import RecordContainer as RefContainer
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.core.record import SCHEMA_NAMES
from filodb_tpu_torch.core.schemas import SCHEMAS
from filodb_tpu_torch.core.store.config import StoreConfig
from filodb_tpu_torch.testing.from_jax import log_stream, open_local
from test_torch_durability import (
    DS,
    _ref_answer,
    _ref_ingest,
    _ref_store,
)

START = 1_600_000_000
N = 120
CFG = StoreConfig(max_chunk_size=50, groups_per_shard=4)
TOL = dict(rtol=2e-5, atol=1e-6, equal_nan=True)
QUERIES = ("u_metric", "sum_over_time(u_metric[5m])",
           "max_over_time(u_metric[10m])", "rate(u_metric[5m])",
           "sum(avg_over_time({_ws_=\"w\"}[5m])) by (_metric_)")


def _raws() -> list[bytes]:
    """Containers of three ``untyped`` and three ``gauge`` series, one a
    scrape, 10 s apart."""
    rng = np.random.default_rng(5)
    vals = np.round((30 + np.cumsum(rng.normal(0, 2, (6, N)), axis=1)) * 4) / 4
    keys = [RefPartKey.create("untyped" if i < 3 else "gauge", {
        "_metric_": "u_metric" if i < 3 else "g_metric", "_ws_": "w",
        "_ns_": "n", "instance": f"i-{i}"}) for i in range(6)]
    out = []
    for s in range(N):
        c = RefContainer()
        for i, k in enumerate(keys):
            c.add(RefRecord(k, (START + 10 * s) * 1000, (float(vals[i, s]),)))
        out.append(c.serialize())
    return out


def _port_ingest(ms, raws, lo=0, hi=None) -> int:
    return sum(ms.shards[0].ingest(sd) for sd in log_stream(raws[lo:hi], lo))


def _port_answer(ms, q, engine="mesh"):
    r = QueryService(ms, device="cpu", engine=engine).query_range(
        q, START + 300, 60, START + 1190)
    m = r.result.materialize()
    keys = [str(k) for k in m.keys]
    order = np.argsort(keys)
    return [keys[i] for i in order], np.asarray(m.values)[order]


def test_untyped_is_the_references_schema_last_in_the_port():
    from filodb_tpu.core.schemas import DEFAULT_SCHEMAS

    ref = DEFAULT_SCHEMAS["untyped"]
    port = SCHEMAS["untyped"]
    assert port.schema_id == ref.schema_id
    assert [c.name for c in port.data.columns] == \
        [c.name for c in ref.data.columns]
    assert SCHEMA_NAMES[-1] == "untyped"
    assert SCHEMA_NAMES[:4] == ("gauge", "prom-counter", "prom-histogram",
                                "ds-gauge")
    assert not port.data.downsamplers and port.data.downsample_schema is None


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    from filodb_tpu.core.memstore.memstore import TimeSeriesMemStore
    from filodb_tpu.core.record import BytesContainer as RefBytes
    from filodb_tpu.core.record import SomeData as RefData
    from filodb_tpu.core.store.config import StoreConfig as RefConfig
    from filodb_tpu_torch.core.memstore.memstore import MemStore

    raws = _raws()
    ref = TimeSeriesMemStore()
    ref.setup(DS, 0, RefConfig(max_chunk_size=50, groups_per_shard=4))
    port = MemStore(1, spread=0, config=CFG)
    rows = {"ref": 0, "port": _port_ingest(port, raws)}
    for off, raw in enumerate(raws):
        rows["ref"] += ref.get_shard(DS, 0).ingest(RefData(RefBytes(raw),
                                                           off))
    return ref, port, rows


def test_no_untyped_record_is_lost(stores):
    ref, port, rows = stores
    assert rows["port"] == rows["ref"] == 6 * N
    shard = port.shards[0]
    assert shard.num_partitions == 6
    assert sorted(k.schema for k in shard.keys) == \
        ["gauge"] * 3 + ["untyped"] * 3


@pytest.mark.parametrize("q", QUERIES)
@pytest.mark.parametrize("engine", ["mesh", "exec"])
def test_untyped_answers_as_every_reference_lane(stores, q, engine):
    from filodb_tpu.coordinator.query_service import QueryService as RefSvc

    ref, port, _ = stores
    got_k, got = _port_answer(port, q, engine)
    assert got_k and np.isfinite(got).any()
    lanes = [RefSvc(ref, DS, 1, spread=0, engine=e) for e in ("exec",
                                                              "mesh")]
    for svc in lanes:
        r = svc.query_range(q, START + 300, 60, START + 1190)
        r.result.materialize()
        m = r.result
        keys = [str(k) for k in m.keys]
        order = np.argsort(keys)
        assert got_k == [keys[i] for i in order], (q, svc.engine)
        np.testing.assert_allclose(got, np.asarray(m.values)[order], **TOL,
                                   err_msg=f"{q} {svc.engine}")


def test_a_reference_directory_with_untyped_recovers_in_the_port(tmp_path):
    from test_torch_durability import _Log

    raws = _raws()
    ref = _ref_store(tmp_path)
    _ref_ingest(ref, raws, 0, 80)
    ref.flush_all(DS)
    _ref_ingest(ref, raws, 80)
    want = {q: _ref_answer(ref, q, START + 300, 60, START + 1190)
            for q in QUERIES[:3]}
    ref.column_store.close()
    ref.meta_store.close()
    from filodb_tpu_torch.testing.from_jax import restart

    ms = open_local(str(tmp_path), config=CFG)
    got = restart(ms, {0: _Log(raws)})
    assert got["keys"] == 6
    assert sorted(k.schema for k in ms.shards[0].keys) == \
        ["gauge"] * 3 + ["untyped"] * 3
    for q, (wk, wv) in want.items():
        k, v = _port_answer(ms, q)
        assert k == wk and k
        np.testing.assert_allclose(v, wv, **TOL, err_msg=q)
    ms.close()


def test_a_port_directory_with_untyped_recovers_in_the_reference(tmp_path):
    raws = _raws()
    ms = open_local(str(tmp_path), config=CFG)
    _port_ingest(ms, raws, 0, 80)
    ms.flush_all()
    _port_ingest(ms, raws, 80)
    want = {q: _port_answer(ms, q) for q in QUERIES[:3]}
    ms.close()
    ref = _ref_store(tmp_path)
    shard = ref.get_shard(DS, 0)
    assert shard.recover_index() == 6
    start = shard.setup_watermarks_for_recovery()
    _ref_ingest(ref, raws, max(start, 0))
    for q, (wk, wv) in want.items():
        k, v = _ref_answer(ref, q, START + 300, 60, START + 1190)
        assert k == wk and k
        np.testing.assert_allclose(v, wv, **TOL, err_msg=q)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_index_snapshots_carry_untyped_partitions(tmp_path, writer):
    """A snapshot written by either package restores the ``untyped``
    partitions in the port."""
    raws = _raws()
    if writer == "ref":
        ref = _ref_store(tmp_path)
        _ref_ingest(ref, raws)
        ref.flush_all(DS)
        ref.get_shard(DS, 0).snapshot_index()
        ref.column_store.close()
        ref.meta_store.close()
    else:
        ms = open_local(str(tmp_path), config=CFG)
        _port_ingest(ms, raws)
        ms.flush_all()
        ms.shards[0].snapshot_index()
        ms.close()
    ms = open_local(str(tmp_path), config=CFG)
    assert ms.recover_index(0) == 6
    assert ms.shards[0].recovered_from == "snapshot"
    assert sorted(k.schema for k in ms.shards[0].keys) == \
        ["gauge"] * 3 + ["untyped"] * 3
    k, v = _port_answer(ms, "max_over_time(u_metric[10m])")
    assert len(k) == 3 and np.isfinite(v).any()
    ms.close()


def test_the_downsampler_job_skips_untyped(tmp_path):
    from filodb_tpu.core.downsample import DownsamplerJob as RefJob
    from filodb_tpu.core.store.localstore import LocalDiskColumnStore as RefCS
    from filodb_tpu_torch.core.downsample import DownsamplerJob
    from filodb_tpu_torch.core.store.localstore import LocalDiskColumnStore

    raws = _raws()
    ms = open_local(str(tmp_path / "p"), config=CFG)
    _port_ingest(ms, raws)
    ms.flush_all(ingestion_time=10)
    ms.close()
    import shutil

    shutil.copytree(tmp_path / "p", tmp_path / "r")
    cs = LocalDiskColumnStore(str(tmp_path / "p"))
    stats = DownsamplerJob(cs, DS, 1, resolutions_ms=(300_000,)).run(0, 100)
    ds_keys = cs.scan_part_keys(f"{DS}_ds_5m", 0)
    rcs = RefCS(str(tmp_path / "r"))
    RefJob(rcs, DS, 1, resolutions_ms=(300_000,)).run(0, 100)
    ref_keys = rcs.scan_part_keys(f"{DS}_ds_5m", 0)
    assert stats["partitions"] == 3
    assert sorted(str(r.part_key.labels) for r in ds_keys) == \
        sorted(str(tuple(sorted(r.part_key.labels.items()))
                   if isinstance(r.part_key.labels, dict)
                   else r.part_key.labels) for r in ref_keys)
    assert all(r.part_key.label_map["_metric_"] == "g_metric"
               for r in ds_keys)
    cs.close()
    rcs.close()
