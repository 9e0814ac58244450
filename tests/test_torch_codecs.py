"""The port's write-path formats against the JAX package's, byte for byte:
NibblePack (the host C++ codec and its pure-Python twin), every vector
codec a chunk uses, ``Chunk.serialize`` (without the summary section) both
ways, the batched chunk encoder and decoder, record containers both
ways with the port's columnar container scan, and the device-page block
encoders (host C++) against their numpy twins.

Inputs are seeded with numpy: jittered timestamps, counters with resets,
NaN and ±inf values, one sample, empty input. Every comparison is bitwise
(bytes, or values compared by their bit patterns).
"""

import numpy as np
import pytest

from filodb_tpu.core.partkey import PartKey as RefPartKey
from filodb_tpu.core.record import IngestRecord as RefRecord
from filodb_tpu.core.record import RecordContainer as RefContainer
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS
from filodb_tpu.memory import chunk as rchunk
from filodb_tpu.memory import codecs as rcod
from filodb_tpu.memory import nibblepack as rnib
from filodb_tpu_torch.core.partkey import PartKey
from filodb_tpu_torch.core.record import (
    IngestRecord,
    RecordContainer,
    parse_container,
)
from filodb_tpu_torch.core.schemas import SCHEMAS
from filodb_tpu_torch.memory import chunk as pchunk
from filodb_tpu_torch.memory import codecs as pcod
from filodb_tpu_torch.memory import nibblepack as pnib

T0 = 1_600_000_000_000


def _bits(a) -> bytes:
    return np.ascontiguousarray(a).tobytes()


def _u64(rng, n):
    """uint64 values of every magnitude, with zeros and runs of zeros."""
    v = rng.integers(0, 2**64, n, dtype=np.uint64) \
        >> rng.integers(0, 64, n).astype(np.uint64)
    v[rng.random(n) < 0.2] = 0
    if n > 20:
        v[5:20] = 0
    return v


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 400, 1000])
def test_nibble_pack_cpp_twin_and_reference_agree(n):
    v = _u64(np.random.default_rng(n), n)
    packed = pnib.nibble_pack(v)
    assert packed == pnib.nibble_pack_py(v) == rnib.nibble_pack_py(v)
    for unpack in (pnib.nibble_unpack, pnib.nibble_unpack_py):
        np.testing.assert_array_equal(unpack(packed, n), v)


def test_nibble_unpack_raises_on_truncated_input():
    packed = pnib.nibble_pack(np.arange(1, 100, dtype=np.uint64) << 40)
    with pytest.raises(ValueError):
        pnib.nibble_unpack(packed[:-3], 99)


def test_zigzag_matches_the_reference():
    v = np.random.default_rng(1).integers(-2**62, 2**62, 500)
    v[:4] = [0, -1, np.iinfo(np.int64).min, np.iinfo(np.int64).max]
    z = pnib.zigzag_encode(v)
    np.testing.assert_array_equal(z, rnib.zigzag_encode(v))
    np.testing.assert_array_equal(pnib.zigzag_decode(z), v)


def _int_cases():
    rng = np.random.default_rng(2)
    jitter = T0 + np.arange(400) * 10_000 + rng.integers(-500, 501, 400)
    return {
        "jittered": jitter,
        "regular": T0 + np.arange(400) * 10_000,
        "one": np.array([T0]),
        "empty": np.zeros(0, np.int64),
        "descending": T0 - np.arange(50) * 7,
        "counter_reset": np.concatenate([np.arange(100) * 3,
                                         np.arange(50) * 2]),
        "wide": rng.integers(-2**40, 2**40, 200),
    }


def _float_cases():
    rng = np.random.default_rng(3)
    counter = np.cumsum(rng.integers(0, 20, 400)).astype(float)
    counter[200:] -= counter[200]
    special = rng.normal(0, 1e3, 64)
    special[[3, 9, 10]] = np.nan
    special[[4, 30]] = [np.inf, -np.inf]
    return {
        "counter_reset": counter,
        "special": special,
        "const": np.full(40, 2.5),
        "const_nan": np.full(9, np.nan),
        "one": np.array([42.0]),
        "empty": np.zeros(0),
        "gauge": rng.normal(50, 30, 333),
    }


@pytest.mark.parametrize("case", list(_int_cases()))
def test_int_codecs_byte_equal(case):
    v = _int_cases()[case]
    for enc in ("encode_delta_delta", "encode_packed_int", "encode_int"):
        got = getattr(pcod, enc)(v)
        assert got == getattr(rcod, enc)(v), enc
        np.testing.assert_array_equal(pcod.decode_any(got),
                                      rcod.decode_any(got))
        if len(v):
            np.testing.assert_array_equal(pcod.decode_any(got), v)


@pytest.mark.parametrize("case", list(_float_cases()))
def test_float_codecs_byte_equal(case):
    v = _float_cases()[case]
    for enc in ("encode_double", "encode_xor_double", "encode_raw_double"):
        got = getattr(pcod, enc)(v)
        assert got == getattr(rcod, enc)(v), enc
        assert _bits(pcod.decode_any(got)) == _bits(rcod.decode_any(got))
        assert _bits(pcod.decode_any(got)) == _bits(v.astype(np.float64))
    got = pcod.encode_const_double(-0.0, 7)
    assert got == rcod.encode_const_double(-0.0, 7)
    assert _bits(pcod.decode_any(got)) == _bits(np.full(7, -0.0))


@pytest.mark.parametrize("rows,nb", [(400, 12), (1, 5), (0, 3), (37, 1)])
def test_hist_2d_delta_byte_equal(rows, nb):
    rng = np.random.default_rng(rows + nb)
    h = np.cumsum(np.cumsum(rng.integers(0, 9, (rows, nb)), 1), 0)
    if rows > 10:
        h[rows // 2:] -= h[rows // 2]  # every bucket resets
    les = np.concatenate([np.geomspace(0.01, 10, nb - 1), [np.inf]])
    got = pcod.encode_hist_2d_delta(h, les)
    assert got == rcod.encode_hist_2d_delta(h, les)
    dec = pcod.decode_any(got)
    np.testing.assert_array_equal(dec.rows, rcod.decode_any(got).rows)
    np.testing.assert_array_equal(dec.rows, h.reshape(rows, nb))
    assert _bits(dec.les) == _bits(les)


def _scalar_chunk(rng, n, seq, special=False):
    ts = T0 + np.arange(n) * 10_000 + rng.integers(-500, 501, n)
    vals = np.cumsum(rng.integers(0, 20, n)).astype(float)
    if special and n > 10:
        vals[[2, 3, 7]] = [np.nan, np.inf, -np.inf]
    return ts, vals


def test_chunk_serialize_byte_equal_both_ways():
    rng = np.random.default_rng(4)
    rs, ps = DEFAULT_SCHEMAS["prom-counter"], SCHEMAS["prom-counter"]
    for n, seq in ((400, 0), (1, 4095), (123, 4097)):
        ts, vals = _scalar_chunk(rng, n, seq, special=True)
        ref = rchunk.encode_chunk(rs, ts, [vals], seq, with_summary=False)
        port = pchunk.encode_chunk(ps, ts, [vals], seq)
        assert port.serialize() == ref.serialize()
        assert port.id == ref.id == pchunk.chunk_id(int(ts[0]), seq)
        assert port.nbytes == ref.nbytes
        # with the summary section: the same bytes, read by either package
        full = rchunk.encode_chunk(rs, ts, [vals], seq).serialize()
        assert len(full) > len(ref.serialize())
        assert pchunk.encode_chunk(ps, ts, [vals], seq,
                                   with_summary=True).serialize() == full
        back = pchunk.Chunk.deserialize(full)
        assert back.serialize() == full
        assert back.summary[1].stats.tobytes() == \
            rchunk.Chunk.deserialize(full).summary[1].stats.tobytes()
        assert rchunk.Chunk.deserialize(port.serialize()) == ref
        assert _bits(back.decode_column(1)) == _bits(vals)


def test_histogram_chunk_byte_equal():
    rng = np.random.default_rng(5)
    rs, ps = DEFAULT_SCHEMAS["prom-histogram"], SCHEMAS["prom-histogram"]
    n, nb = 300, 10
    ts = T0 + np.arange(n) * 10_000 + rng.integers(-500, 501, n)
    h = np.cumsum(np.cumsum(rng.integers(0, 5, (n, nb)), 1), 0)
    les = np.concatenate([np.geomspace(0.025, 10, nb - 1), [np.inf]])
    sums, cnts = 0.2 * h[:, -1].astype(float), h[:, -1].astype(float)
    cols = [sums, cnts, rcod.HistogramColumn(les, h)]
    ref = rchunk.encode_chunk(rs, ts, cols, 3, with_summary=False)
    port = pchunk.encode_chunk(ps, ts, [sums, cnts,
                                        pcod.HistogramColumn(les, h)], 3)
    assert port.serialize() == ref.serialize()


def test_batched_encode_equals_per_chunk_and_decodes_back():
    """``encode_chunks`` (host C++, many chunks a call) writes the bytes
    ``encode_chunk`` writes chunk by chunk, the reference's too, and
    ``decode_chunks`` gives the rows back bit for bit."""
    rng = np.random.default_rng(6)
    C, M = 40, 64
    ts = T0 + np.arange(M)[None, :] * 10_000 + rng.integers(-500, 501, (C, M))
    vals = np.cumsum(rng.integers(0, 20, (C, M)), 1).astype(float)
    vals[3, 5:9] = np.nan
    vals[4] = 7.0
    vals[5, ::3] = np.inf
    rows = rng.integers(1, M + 1, C)
    rows[:2] = [1, M]
    seq = rng.integers(0, 5000, C)
    ids = pchunk.chunk_ids(ts[:, 0], seq)
    cb = pchunk.encode_chunks(ts, vals[:, None, :], rows, ids)
    rs, ps = DEFAULT_SCHEMAS["prom-counter"], SCHEMAS["prom-counter"]
    for i in range(C):
        n = rows[i]
        ref = rchunk.encode_chunk(rs, ts[i, :n], [vals[i, :n]], int(seq[i]),
                                  with_summary=False)
        assert bytes(cb.data(i)) == ref.serialize()
        assert cb.nbytes[i] == ref.nbytes
    d = pchunk.decode_chunks(cb, ps)
    np.testing.assert_array_equal(d.ids, ids)
    np.testing.assert_array_equal(d.rows, rows)
    for i in range(C):
        n = rows[i]
        np.testing.assert_array_equal(d.ts[i, :n], ts[i, :n])
        assert _bits(d.dcols[i, 0, :n]) == _bits(vals[i, :n])
    sub = cb.take(np.array([7, 2, 7]))
    assert bytes(sub.data(2)) == bytes(cb.data(7))

    # histograms: buckets in the first B of B + 2 slots, sum and count
    B = 6
    h = np.cumsum(np.cumsum(rng.integers(0, 4, (C, M, B)), 2), 1)
    h[9, 30:] -= h[9, 30]
    slots = np.concatenate([h, np.zeros((C, M, 2), np.int64)], axis=2)
    les = np.tile(np.concatenate([np.geomspace(0.1, 5, B - 1), [np.inf]]),
                  (C, 1))
    sums, cnts = rng.random((C, M)), h[:, :, -1].astype(float)
    hb = pchunk.encode_chunks(ts, np.stack([sums, cnts], 1), rows, ids,
                              hist=slots, les=les)
    hs = DEFAULT_SCHEMAS["prom-histogram"]
    for i in range(C):
        n = rows[i]
        ref = rchunk.encode_chunk(hs, ts[i, :n], [
            sums[i, :n], cnts[i, :n], rcod.HistogramColumn(les[i], h[i, :n])],
            int(seq[i]), with_summary=False)
        assert bytes(hb.data(i)) == ref.serialize()
    np.testing.assert_array_equal(
        pchunk.bucket_counts(hb, SCHEMAS["prom-histogram"]), B)
    d = pchunk.decode_chunks(hb, SCHEMAS["prom-histogram"])
    for i in range(C):
        n = rows[i]
        np.testing.assert_array_equal(d.hist[i, :n], h[i, :n])
        assert _bits(d.dcols[i, 0, :n]) == _bits(sums[i, :n])
    assert _bits(d.les) == _bits(les)


def test_decode_rejects_a_truncated_chunk():
    rng = np.random.default_rng(7)
    ts, vals = _scalar_chunk(rng, 100, 0)
    blob = pchunk.encode_chunk(SCHEMAS["gauge"], ts, [vals]).serialize()
    cb = pchunk.ChunkBytes.from_blobs([blob[:-20]])
    with pytest.raises(ValueError):
        pchunk.decode_chunks(cb, SCHEMAS["gauge"])


def _ref_records(rng):
    les = np.array([0.1, 1.0, np.inf])
    keys = [RefPartKey.create("gauge", {"_metric_": "g", "_ns_": f"n{i}",
                                        "host": f"h-é{i}"}) for i in range(3)]
    keys.append(RefPartKey.create("prom-counter", {"_metric_": "c",
                                                   "job": "j"}))
    hk = RefPartKey.create("prom-histogram", {"_metric_": "lat", "le_x": ""})
    out = RefContainer()
    for t in range(5):
        for k in keys:
            v = float(rng.normal()) if t != 2 else np.nan
            out.add(RefRecord(k, T0 + t * 10_000, (v,)))
        counts = np.cumsum(rng.integers(0, 5, 3))
        out.add(RefRecord(hk, T0 + t * 10_000,
                          (0.5 * t, float(counts[-1]), (les, counts))))
    return out


def _port_container(ref: RefContainer) -> RecordContainer:
    out = RecordContainer()
    for r in ref:
        vals = tuple((np.asarray(v[0]), np.asarray(v[1]))
                     if isinstance(v, tuple) else v for v in r.values)
        out.add(IngestRecord(PartKey(r.part_key.schema, r.part_key.labels),
                             r.timestamp, vals))
    return out


def test_record_containers_byte_equal_both_ways():
    ref = _ref_records(np.random.default_rng(8))
    raw = ref.serialize()
    port = _port_container(ref)
    assert port.serialize() == raw
    back = RecordContainer.deserialize(raw)
    assert back.serialize() == raw
    assert RefContainer.deserialize(port.serialize()).serialize() == raw
    with pytest.raises(ValueError):
        RecordContainer.deserialize(b"\x01" + raw[1:])


def test_container_scan_gives_the_records_as_columns():
    ref = _ref_records(np.random.default_rng(9))
    cols = parse_container(ref.serialize())
    recs = list(ref)
    assert len(cols) == len(recs)
    np.testing.assert_array_equal(cols.part_hash,
                                  [r.part_key.part_hash for r in recs])
    np.testing.assert_array_equal(cols.ts, [r.timestamp for r in recs])
    assert cols.keys == [r.part_key.serialized for r in recs]
    first = np.array([r.values[0] for r in recs])
    assert _bits(cols.dvals[:, 0]) == _bits(first)
    hist = np.flatnonzero(cols.hist_off >= 0)
    assert [recs[i].part_key.schema for i in hist] == ["prom-histogram"] * 5
    les, counts = cols.histograms(hist)
    for j, i in enumerate(hist):
        np.testing.assert_array_equal(counts[j], recs[i].values[2][1])
        assert _bits(les[j]) == _bits(recs[i].values[2][0])
        assert cols.dvals[i, 1] == recs[i].values[1]
    np.testing.assert_array_equal(cols.bucket_counts()[hist], 3)
    with pytest.raises(ValueError):
        parse_container(ref.serialize()[:-5])


def test_page_block_encoders_cpp_equal_numpy_twins():
    """The device-page block encoders (host C++) against their numpy twins,
    bit for bit: every residual width 0..32, empty and partial blocks,
    slopes past int32, NaN and ±inf values; and the over-wide residual
    still raises."""
    from filodb_tpu_torch.memory import device_pages as dp

    rng = np.random.default_rng(10)
    nb = 4000
    width = np.arange(nb) % 33
    resid = rng.integers(0, 2**32, (nb, 128), dtype=np.uint64) \
        >> (32 - width[:, None]).astype(np.uint64)
    ts = (T0 + np.arange(128) * 10_000)[None, :] + resid.astype(np.int64) // 2
    ts[::17] += np.arange(128) * 2**33  # slope past int32
    n = rng.integers(0, 129, nb)
    n[:3] = [0, 1, 128]
    for got, want in zip(dp.encode_ts_blocks(ts, n),
                         dp.encode_ts_blocks_py(ts, n)):
        assert got.dtype == want.dtype and _bits(got) == _bits(want)
    vals = rng.normal(0, 1e3, (nb, 128)).astype(np.float32)
    vals[::5] = np.round(vals[::5])
    vals[::7] = 2.5
    vals[1::9, ::13] = np.nan
    vals[2::11, 5] = [np.inf, -np.inf] * (len(vals[2::11]) // 2) + \
        [np.inf] * (len(vals[2::11]) % 2)
    for got, want in zip(dp.encode_f32_blocks(vals, n),
                         dp.encode_f32_blocks_py(vals, n)):
        assert got.dtype == want.dtype and _bits(got) == _bits(want)
    wide = np.zeros((1, 128), np.int64)
    wide[0, 64] = 2**40
    with pytest.raises(ValueError, match="residual too large"):
        dp.encode_ts_blocks(wide, np.array([128]))
    with pytest.raises(ValueError, match="residual too large"):
        dp.encode_ts_blocks_py(wide, np.array([128]))
