"""The port's multi-device query programs (``filodb_tpu_torch/parallel/
dist_query.py``) on gloo groups of CPU processes, against the reference's
programs on JAX's 8-device CPU mesh (``tests/conftest.py``).

The reference's cases (``tests/test_dist_query.py``: sum-rate, resets on
the time blocks' boundary, empty groups, ``range_agg`` over fn × agg, the
ring against the gather form, the ring's extrapolation case) and the
split pipeline against the fused program (``tests/test_mesh_sharded.py``,
at the program level) run in the reference's 4×2 layout, a 2×2 and a 1×1:
one group a layout a module (``testing/dist_run.run_group``: every case in
one go, the results handed back through files), each port answer held
against the reference's program in the same layout over the same seeded
numpy inputs at rtol 1e-9, atol 1e-12, and the 1×1 answers against the
port's own float64 ``kernels.range_eval`` plus ``aggregations.aggregate``.
The ring agrees with the gather form and the split pipeline with the
fused program bit for bit. ``pad_for_mesh`` and ``shard_batch_arrays``
are held against the reference's on odd P and S. Every group has a
deadline.

The single controller's back-end: every case also runs over a
``LocalMesh`` of CPU slots in the same layout, in this process, and equals
the gloo group's answer (per-series rows and blocks bit for bit; an
aggregate within rtol 1e-9, atol 1e-12, as gloo's reduction over
``shard`` need not add the shards in row order).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from filodb_tpu.parallel import dist_query as ref_dq
from filodb_tpu.query.engine.batch import TS_PAD
from filodb_tpu_torch.parallel import dist_query as dq
from filodb_tpu_torch.query.engine import aggregations, kernels
from filodb_tpu_torch.testing.dist_run import run_case, run_group

RTOL, ATOL = 1e-9, 1e-12
LAYOUTS = {"4x2": (4, 2), "2x2": (2, 2), "1x1": (1, 1)}
GROUP_TIMEOUT_S = 240


def make_series(P=12, S=200, seed=0, resets=True):
    """The reference test's generator (``tests/test_dist_query.py``)."""
    rng = np.random.default_rng(seed)
    ts = np.full((P, S), TS_PAD, np.int32)
    vals = np.zeros((P, S), np.float64)
    counts = np.zeros(P, np.int32)
    for p in range(P):
        n = int(rng.integers(S // 2, S))
        t = np.cumsum(rng.integers(5_000, 15_000, n))
        v = np.cumsum(rng.integers(0, 20, n)).astype(float)
        if resets and n > 50:
            r = int(rng.integers(20, n - 10))
            v[r:] -= v[r]
        ts[p, :n] = t
        vals[p, :n] = v
        counts[p] = n
    return ts, vals, counts


def boundary_series():
    """Counters that reset exactly at S/2, where the time axis splits."""
    P, S = 4, 160
    ts = np.full((P, S), TS_PAD, np.int32)
    vals = np.zeros((P, S), np.float64)
    for p in range(P):
        ts[p] = np.arange(S, dtype=np.int64) * 10_000 + 10_000
        v = np.cumsum(np.ones(S)) * (p + 1)
        v[S // 2:] -= v[S // 2]
        vals[p] = v
    return ts, vals, np.full(P, S, np.int32)


def late_series():
    """First samples only in the second time block: extrapolation hangs on
    the true global t_first."""
    P_, S = 8, 128
    ts = np.full((P_, S), TS_PAD, np.int32)
    vals = np.zeros((P_, S), np.float64)
    counts = np.zeros(P_, np.int32)
    rng = np.random.default_rng(33)
    for p in range(P_):
        n = 40
        ts[p, :n] = 900_000 + p * 1000 + np.arange(n) * 10_000
        vals[p, :n] = np.cumsum(rng.integers(1, 10, n)).astype(float)
        counts[p] = n
    return ts, vals, counts


STEPS = np.arange(600_000, 1_500_000, 60_000, dtype=np.int32)
AGG_STEPS = np.arange(400_000, 1_000_000, 60_000, dtype=np.int32)

# name → (inputs, gids, num_groups, steps, window)
DATA = {
    "counters": (make_series(12, 200, 0), np.arange(12) % 3, 3, STEPS,
                 300_000),
    "boundary": (boundary_series(), np.zeros(4), 1,
                 np.array([900_000, 1_200_000], np.int32), 600_000),
    "empty": (make_series(4, 64, 5), np.zeros(4), 2,
              np.array([10], np.int32), 5),
    "gauges": (make_series(8, 128, 11, resets=False), np.arange(8) % 2, 2,
               AGG_STEPS, 300_000),
    "ring": (make_series(12, 200, 21), np.arange(12) % 3, 3, STEPS,
             300_000),
    "late": (late_series(), np.zeros(8), 1,
             np.array([1_400_000, 1_500_000], np.int32), 900_000),
    "odd": (make_series(13, 97, 3), np.arange(13) % 4, 4, STEPS, 300_000),
}

RANGE_AGG = ([("sum_over_time", "sum"), ("count_over_time", "sum"),
              ("avg_over_time", "avg"), ("min_over_time", "min"),
              ("max_over_time", "max"), ("last_over_time", "sum")]
             + [(f, "sum") for f in ("rate", "increase", "delta",
                                     "present_over_time",
                                     "stddev_over_time",
                                     "stdvar_over_time")]
             + [("rate", a) for a in dq.MESH_AGG_OPS if a != "sum"]
             + [("rate", None), ("max_over_time", None)])
SPLIT = ([(f, "sum") for f in dq.SPLIT_FNS]
         + [("rate", a) for a in ("avg", "min", "max", "count", "stddev")]
         + [("rate", None), ("avg_over_time", None)])

# case → (data, program, fn, agg)
CASES = {
    "sum_rate": ("counters", "sum_rate", "rate", "sum"),
    "sum_rate_boundary": ("boundary", "sum_rate", "rate", "sum"),
    "sum_rate_empty": ("empty", "sum_rate", "rate", "sum"),
    "sum_rate_odd": ("odd", "sum_rate", "rate", "sum"),
    "ring": ("ring", "ring", "rate", "sum"),
    "ring_gather": ("ring", "sum_rate", "rate", "sum"),
    "ring_late": ("late", "ring", "rate", "sum"),
    "ring_odd": ("odd", "ring", "rate", "sum"),
    **{f"range_agg:{fn}:{agg}": ("counters" if fn in dq.COUNTER_FNS
                                 else "gauges", "range_agg", fn, agg)
       for fn, agg in RANGE_AGG},
    **{f"split:{fn}:{agg}": ("counters" if fn in dq.COUNTER_FNS
                             else "gauges", "split", fn, agg)
       for fn, agg in SPLIT},
    **{f"fused:{fn}:{agg}": ("counters" if fn in dq.COUNTER_FNS
                             else "gauges", "range_agg", fn, agg)
       for fn, agg in SPLIT},
    "blocks_odd": ("odd", "blocks", None, None),
}


def _ref_mesh(layout):
    ds, dt = LAYOUTS[layout]
    return Mesh(np.array(jax.devices()[:ds * dt]).reshape(ds, dt),
                ("shard", "time"))


def _padded(data: str, layout: str):
    (ts, vals, counts), gids, G, steps, window = DATA[data]
    return dq.pad_for_mesh(ts, vals, counts, gids.astype(np.int32),
                           LAYOUTS[layout])


_GROUPS: dict = {}


def _case(name: str, layout: str) -> dict:
    data, program, fn, agg = CASES[name]
    ts, vals, valid, gids = _padded(data, layout)
    _, _, G, steps, window = DATA[data]
    return dict(name=name, program=program, fn=fn, agg=agg, num_groups=G,
                ts=ts, vals=vals, valid=valid, gids=gids, steps=steps,
                window=window)


def _run_layout(layout: str, tmp_path_factory) -> list:
    """Every rank's results of one gloo group in ``layout``, run once a
    module."""
    if layout not in _GROUPS:
        cases = [_case(name, layout) for name in CASES]
        ds, dt = LAYOUTS[layout]
        _GROUPS[layout] = run_group(
            cases, ds, dt, str(tmp_path_factory.mktemp(layout)),
            timeout_s=GROUP_TIMEOUT_S)
    return _GROUPS[layout]


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def group(request, tmp_path_factory):
    """(layout, every rank's results): one gloo group a layout."""
    return request.param, _run_layout(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def one_by_one(tmp_path_factory):
    return _run_layout("1x1", tmp_path_factory)


def _answer(res, name: str, agg) -> np.ndarray:
    """A case's global answer: [G, K] from rank 0 (every rank holds it),
    or the per-series rows stitched by shard (the time blocks of a shard
    hold the same rows)."""
    if agg is not None:
        for r in res[1:]:
            np.testing.assert_array_equal(r[name], res[0][name])
        return res[0][name]
    rows = sorted((r["coords"][0], r[name]) for r in res
                  if r["coords"][1] == 0)
    return np.concatenate([x for _, x in rows])


@functools.lru_cache(maxsize=None)
def _reference(layout: str, data: str, program: str, fn, agg):
    """The reference's program in the same layout over the same inputs."""
    mesh = _ref_mesh(layout)
    ts, vals, valid, gids = (jnp.asarray(a) for a in _padded(data, layout))
    _, _, G, steps, window = DATA[data]
    args = (ts, vals, valid, gids, jnp.asarray(steps),
            jnp.asarray(np.int32(window)))
    if program == "sum_rate":
        f = ref_dq.make_distributed_sum_rate(mesh, G)
    elif program == "ring":
        f = ref_dq.make_distributed_sum_rate_ring(mesh, G)
    else:
        f = ref_dq.make_distributed_range_agg(mesh, fn, G, agg)
    return np.asarray(f(*args))


def _single_device(data: str, fn: str, agg):
    """The port's own float64 range_eval plus aggregate, unpadded."""
    (ts, vals, counts), gids, G, steps, window = DATA[data]
    per = kernels.range_eval(fn, torch.as_tensor(ts), torch.as_tensor(vals),
                             torch.as_tensor(counts),
                             torch.as_tensor(steps), int(window))
    if agg is None:
        return per.numpy()
    return aggregations.aggregate(agg, per, torch.as_tensor(gids), G).numpy()


PROGRAM_CASES = [c for c, v in CASES.items() if v[1] in ("sum_rate", "ring",
                                                         "range_agg")
                 and not c.startswith("fused:")]


@pytest.mark.parametrize("case", PROGRAM_CASES)
def test_program_matches_the_references(group, case):
    layout, res = group
    data, program, fn, agg = CASES[case]
    got = _answer(res, case, agg)
    want = _reference(layout, data, program, fn, agg)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               equal_nan=True, err_msg=f"{layout} {case}")
    if case == "sum_rate_empty":
        assert np.isnan(got).all()


@pytest.mark.parametrize("case", [c for c in PROGRAM_CASES
                                  if CASES[c][0] != "empty"])
def test_one_by_one_matches_the_ports_own_functions(one_by_one, case):
    data, program, fn, agg = CASES[case]
    got = _answer(one_by_one, case, agg)
    P = DATA[data][0][0].shape[0]
    want = _single_device(data, fn, agg)
    np.testing.assert_allclose(got[:P] if agg is None else got, want,
                               rtol=RTOL, atol=ATOL, equal_nan=True)


def test_ring_matches_gather_bitwise(group):
    _, res = group
    assert _answer(res, "ring", "sum").tobytes() == \
        _answer(res, "ring_gather", "sum").tobytes()


@pytest.mark.parametrize("fn,agg", SPLIT, ids=[f"{f}-{a}" for f, a in SPLIT])
def test_split_pipeline_equals_fused_bitwise(group, fn, agg):
    _, res = group
    split = _answer(res, f"split:{fn}:{agg}", agg)
    fused = _answer(res, f"fused:{fn}:{agg}", agg)
    assert split.shape == fused.shape
    assert split.tobytes() == fused.tobytes()


def test_shard_batch_arrays_match_the_references(group):
    """Each rank's blocks are the reference's ``device_put`` shard on the
    device at the same mesh coordinates."""
    layout, res = group
    mesh = _ref_mesh(layout)
    ts, vals, valid, gids = _padded("odd", layout)
    placed = ref_dq.shard_batch_arrays(mesh, ts, vals, valid, gids)
    devs = mesh.devices
    for r in res:
        s, t = r["coords"]
        dev = devs[s, t]
        for got, arr in zip(r["blocks_odd"], placed):
            (shard,) = [x for x in arr.addressable_shards
                        if x.device == dev]
            np.testing.assert_array_equal(got, np.asarray(shard.data))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("P,S", [(13, 97), (7, 3), (1, 1), (12, 200)])
def test_pad_for_mesh_matches_the_references(layout, P, S):
    ts, vals, counts = make_series(P, max(S, 2), seed=P * S)
    ts, vals = ts[:, :S], vals[:, :S]
    counts = np.minimum(counts, S)
    vals[0, 0] = np.nan  # padding zeroes NaN in both
    gids = (np.arange(P) % 3).astype(np.int32)
    got = dq.pad_for_mesh(ts, vals, counts, gids, LAYOUTS[layout])
    want = ref_dq.pad_for_mesh(ts, vals, counts, gids, _ref_mesh(layout))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_split_fns_are_the_references():
    assert dq.SPLIT_FNS == ref_dq.SPLIT_FNS
    assert dq.MESH_AGG_OPS == ref_dq.MESH_AGG_OPS
    assert dq.COUNTER_FNS == ref_dq.COUNTER_FNS
    assert set(dq._SIMPLE_COMBINE) == set(ref_dq._SIMPLE_COMBINE)


def _local_mesh(layout: str) -> dq.LocalMesh:
    ds, dt = LAYOUTS[layout]
    return dq.LocalMesh([["cpu"] * dt for _ in range(ds)])


@pytest.mark.parametrize("case", [c for c in CASES if c != "blocks_odd"])
def test_local_mesh_equals_the_gloo_group(group, case):
    layout, res = group
    agg = CASES[case][3]
    got = run_case(_local_mesh(layout), _case(case, layout))
    want = _answer(res, case, agg)
    assert got.shape == want.shape
    if agg is None:
        assert got.tobytes() == want.tobytes()
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   equal_nan=True, err_msg=f"{layout} {case}")


def test_local_mesh_blocks_equal_the_gloo_ranks(group):
    layout, res = group
    mesh = _local_mesh(layout)
    got = run_case(mesh, _case("blocks_odd", layout))
    ds, dt = mesh.shape
    for r in res:
        s, t = r["coords"]
        for g, w in zip(got[s * dt + t], r["blocks_odd"]):
            np.testing.assert_array_equal(g, w)


def test_local_mesh_names_its_slots():
    mesh = dq.LocalMesh([["cpu", "cpu"], ["cpu", "cpu"]])
    assert mesh.shape == (2, 2) and len(mesh) == 4
    assert dq.mesh_axes(mesh) == (2, 2)
    assert mesh.root == torch.device("cpu")
    with pytest.raises(ValueError):
        dq.LocalMesh([["cpu"], ["cpu", "cpu"]])
