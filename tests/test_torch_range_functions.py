"""Module parity of the port's plain range functions, aggregations and
instant functions against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through
``filodb_tpu/query/engine/{kernels,aggregations,instantfns}.py`` (x64, as
``tests/conftest.py`` sets it) and their ports. Rows carry interior gaps
(gap positions take the previous real timestamp, as ``assemble`` leaves
them), leading gaps, empty rows and steps past the data, so windows are
empty, partial and full. Tolerance ``rtol=2e-5, atol=1e-6``, NaN equal
(``timestamp``: ``atol=1e-3``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.query.engine import aggregations as ref_agg
from filodb_tpu.query.engine import instantfns as ref_fns
from filodb_tpu.query.engine import kernels as ref_kernels
from filodb_tpu_torch.query.engine import aggregations as port_agg
from filodb_tpu_torch.query.engine import instantfns as port_fns
from filodb_tpu_torch.query.engine import kernels as port_kernels
from filodb_tpu_torch.query.engine.device_batch import TS_GAP_MIN

TOL = dict(rtol=2e-5, atol=1e-6, equal_nan=True)


def _rows(seed: int, counter: bool, P: int = 7, S: int = 256):
    """(ts int32, vals float32, valid, steps int32) with gaps."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.integers(5_000, 15_000, (P, S)), axis=1)
    valid = rng.random((P, S)) > 0.25
    valid[1, :40] = False            # leading gap
    valid[2, 180:] = False           # the row ends early
    valid[3] = False                 # no sample at all
    valid[4, 60:120] = False         # a long interior gap
    if counter:
        vals = np.cumsum(rng.integers(0, 20, (P, S)), axis=1)
        vals[0, 100:] -= vals[0, 100]  # a reset
        vals[5, 30:] -= vals[5, 30] - 3
    else:
        vals = rng.integers(-50, 50, (P, S))
        vals[6, ::3] = 7             # repeated values: ties, no change
    ts = np.maximum.accumulate(np.where(valid, t, TS_GAP_MIN), axis=1)
    steps = np.arange(20_000, int(t.max()) + 400_000, 47_000)
    return (ts.astype(np.int32), vals.astype(np.float32), valid,
            steps.astype(np.int32))


def _ref(fn, ts, vals, valid, steps, window, **kw):
    return np.asarray(ref_kernels.range_eval_masked(
        fn, jnp.asarray(ts), jnp.asarray(vals), jnp.asarray(valid),
        jnp.asarray(steps), jnp.asarray(np.int32(window)), **kw))


def _port(fn, ts, vals, valid, steps, window, **kw):
    return port_kernels.range_eval_masked(
        fn, torch.from_numpy(ts), torch.from_numpy(vals),
        torch.from_numpy(valid), torch.from_numpy(steps), window,
        **kw).numpy()


NEW_FNS = ("min_over_time", "max_over_time", "stddev_over_time",
           "stdvar_over_time", "zscore", "last_over_time", "last_sample",
           "timestamp", "present_over_time", "changes", "resets", "irate",
           "idelta", "deriv", "predict_linear", "sum_over_time",
           "count_over_time", "avg_over_time")


@pytest.mark.parametrize("window", [60_000, 300_000])
@pytest.mark.parametrize("counter", [True, False])
@pytest.mark.parametrize("fn", NEW_FNS)
def test_range_eval_masked_matches_reference(fn, counter, window):
    ts, vals, valid, steps = _rows(len(fn) + counter, counter)
    kw = {"extra": 600.0} if fn == "predict_linear" else {}
    want = _ref(fn, ts, vals, valid, steps, window, **kw)
    got = _port(fn, ts, vals, valid, steps, window, **kw)
    assert np.isnan(want).any() and np.isfinite(want).any()
    tol = dict(rtol=0, atol=1e-3, equal_nan=True) if fn == "timestamp" \
        else TOL
    np.testing.assert_allclose(got, want, err_msg=fn, **tol)


@pytest.mark.parametrize("fn", ["rate", "increase", "delta"])
def test_rate_family_in_float64_matches_reference(fn):
    ts, vals, valid, steps = _rows(3, counter=True)
    want = _ref(fn, ts, vals, valid, steps, 300_000, counter=True)
    got = _port(fn, ts, vals, valid, steps, 300_000, counter=True)
    np.testing.assert_allclose(got, want, **TOL)


def test_min_max_take_a_float32_table_and_exact_levels():
    """Windows of every length 1..S hit every sparse-table level; the
    float32 table's answer cast to float64 is the reference's."""
    rng = np.random.default_rng(4)
    S = 64
    ts = np.tile(np.arange(S, dtype=np.int32) * 10, (2, 1))
    vals = rng.normal(0, 1e3, (2, S)).astype(np.float32)
    valid = np.ones((2, S), bool)
    steps = np.arange(0, S * 10, 10, dtype=np.int32)
    for window in range(10, S * 10 + 1, 70):
        for fn in ("min_over_time", "max_over_time"):
            want = _ref(fn, ts, vals, valid, steps, window)
            got = _port(fn, ts, vals, valid, steps, window)
            np.testing.assert_array_equal(got, want)


def test_floor_log2_is_exact_near_powers_of_two():
    w = torch.tensor([1, 2, 3, 4, 7, 8, 2**24 - 1, 2**24, 2**24 + 1,
                      2**31 - 1], dtype=torch.int64)
    want = [int(x).bit_length() - 1 for x in w]
    assert port_kernels._floor_log2(w).tolist() == want


@pytest.mark.parametrize("q", [0.0, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("counter", [True, False])
def test_quantile_over_time_matches_reference(q, counter):
    ts, vals, valid, steps = _rows(11 + counter, counter)
    want = np.asarray(ref_kernels.quantile_over_time_masked(
        q, jnp.asarray(ts), jnp.asarray(vals), jnp.asarray(valid),
        jnp.asarray(steps), jnp.asarray(np.int32(300_000))))
    got = port_kernels.quantile_over_time_masked(
        q, torch.from_numpy(ts), torch.from_numpy(vals),
        torch.from_numpy(valid), torch.from_numpy(steps), 300_000).numpy()
    assert np.isnan(want).any()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("sf,tf", [(0.5, 0.5), (0.1, 0.9)])
def test_holt_winters_matches_reference(sf, tf):
    ts, vals, valid, steps = _rows(13, counter=False, S=128)
    want = np.asarray(ref_kernels.holt_winters_masked(
        sf, tf, jnp.asarray(ts), jnp.asarray(vals), jnp.asarray(valid),
        jnp.asarray(steps), jnp.asarray(np.int32(300_000))))
    got = port_kernels.holt_winters_masked(
        sf, tf, torch.from_numpy(ts), torch.from_numpy(vals),
        torch.from_numpy(valid), torch.from_numpy(steps), 300_000).numpy()
    assert np.isfinite(want).any() and np.isnan(want).any()
    np.testing.assert_allclose(got, want, **TOL)


def _matrix(seed: int, P: int = 40, K: int = 9, G: int = 5):
    """Per-series values with NaN, repeated values (ties), infinities and
    a group with no sample at a step."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-20, 20, (P, K)).astype(np.float64)
    v[rng.random((P, K)) < 0.2] = np.nan
    v[3, 2], v[7, 4], v[9, 5] = np.inf, -np.inf, np.inf
    gids = rng.integers(0, G, P).astype(np.int32)
    v[gids == 1, 6] = np.nan
    return v, gids, G


@pytest.mark.parametrize("op", port_agg.AGG_OPS)
def test_aggregate_matches_reference(op):
    v, gids, G = _matrix(5)
    v[~np.isfinite(v)] = np.nan  # sums of opposite infinities are NaN alike
    want = np.asarray(ref_agg.aggregate(op, jnp.asarray(v),
                                        jnp.asarray(gids), G))
    got = port_agg.aggregate(op, torch.from_numpy(v),
                             torch.from_numpy(gids), G).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("k", [1, 2, 3, 50])
@pytest.mark.parametrize("bottom", [False, True])
def test_topk_mask_matches_reference(k, bottom):
    v, gids, G = _matrix(6)
    want = np.asarray(ref_agg.topk_mask(jnp.asarray(v), jnp.asarray(gids),
                                        G, k, bottom))
    got = port_agg.topk_mask(torch.from_numpy(v), torch.from_numpy(gids), G,
                             k, bottom).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.9, 1.0])
def test_quantile_across_matches_reference(q):
    v, gids, G = _matrix(7)
    want = np.asarray(ref_agg.quantile_across(q, jnp.asarray(v),
                                              jnp.asarray(gids), G))
    got = port_agg.quantile_across(q, torch.from_numpy(v),
                                   torch.from_numpy(gids), G).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _instant_inputs(fn: str) -> np.ndarray:
    rng = np.random.default_rng(len(fn))
    if fn in port_fns.CALENDAR_FNS:
        v = rng.uniform(-3e9, 4e9, (6, 50))  # epoch seconds, 1875..2096
        v[0, :5] = [0.0, 951_782_400.0, 4_107_542_399.0, -86_400.0, 1e9]
    elif fn in ("asin", "acos", "atanh"):
        v = rng.uniform(-1.2, 1.2, (6, 50))
    else:
        v = rng.normal(0, 20, (6, 50)).round(1)
    v[1, ::7] = np.nan
    return v


INSTANT_CASES = [(f, ()) for f in port_fns.INSTANT_FNS
                 if f not in ("round", "clamp", "clamp_min", "clamp_max")] \
    + [("round", ()), ("round", (5.0,)), ("round", (0.5,)),
       ("clamp", (-3.0, 4.0)), ("clamp", (4.0, -3.0)),
       ("clamp_min", (2.5,)), ("clamp_max", (-1.0,))]


@pytest.mark.parametrize("fn,params", INSTANT_CASES)
def test_instant_fn_matches_reference(fn, params):
    v = _instant_inputs(fn)
    want = np.asarray(ref_fns.apply_instant_fn(fn, jnp.asarray(v),
                                               params=params))
    got = port_fns.apply_instant_fn(fn, torch.from_numpy(v), params).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("bool_mode", [False, True])
@pytest.mark.parametrize("op", port_fns.BINARY_OPS)
def test_binary_op_matches_reference(op, bool_mode):
    rng = np.random.default_rng(9)
    lhs = rng.integers(-4, 5, (5, 30)).astype(np.float64)
    rhs = rng.integers(-4, 5, (5, 30)).astype(np.float64)
    lhs[0, ::4], rhs[1, ::5] = np.nan, np.nan
    want = np.asarray(ref_fns.apply_binary_op(op, jnp.asarray(lhs),
                                              jnp.asarray(rhs), bool_mode))
    got = port_fns.apply_binary_op(op, torch.from_numpy(lhs),
                                   torch.from_numpy(rhs), bool_mode).numpy()
    np.testing.assert_allclose(got, want, **TOL)
