"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked ``gpu``: without a card every test here skips. On the card run
``python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q``
(``tests/conftest.py`` imports JAX, which the card's machine need not
have).
"""

import numpy as np
import pytest
import torch

from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.memory import device_pages as dp
from filodb_tpu_torch.query.engine import cuda_kernels as ck
from filodb_tpu_torch.query.engine.device_batch import (
    pack_series_pages,
    to_device,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _blocks(nb, seed):
    rng = np.random.default_rng(seed)
    widths = np.array(([0, 1, 31, 32, 7] * nb)[:nb], np.int32)
    shifts = np.array(([0, 32, 3, 31] * nb)[:nb], np.int32)
    words = rng.integers(0, 2**32, (nb, 128), dtype=np.uint64).astype(
        np.uint32)
    slopes = rng.integers(-2**31, 2**31 - 1, nb).astype(np.int32)
    firsts = rng.integers(0, 2**32, nb, dtype=np.uint64).astype(np.uint32)
    return (torch.from_numpy(slopes), torch.from_numpy(widths),
            torch.from_numpy(shifts), dp.u32_as_i32(firsts),
            dp.u32_as_i32(words))


@pytest.mark.parametrize("nb", [1, 5, 4099])
def test_b1_b2_bitwise_equal_to_plain(cuda, nb):
    slopes, widths, shifts, firsts, words = _blocks(nb, nb)
    ts_cpu = dp.decode_ts_blocks(slopes, widths, words)
    f_cpu = dp.decode_f32_blocks(firsts, shifts, widths, words)
    ts_gpu = dp.decode_ts_blocks(slopes.to(cuda), widths.to(cuda),
                                 words.to(cuda)).cpu()
    f_gpu = dp.decode_f32_blocks(firsts.to(cuda), shifts.to(cuda),
                                 widths.to(cuda), words.to(cuda)).cpu()
    assert torch.equal(ts_gpu, ts_cpu)
    assert torch.equal(f_gpu.view(torch.int32), f_cpu.view(torch.int32))


def _packed(n_series, n, seed):
    rng = np.random.default_rng(seed)
    per = []
    for i in range(n_series):
        ts = np.cumsum(rng.integers(8000, 12000, n)).astype(np.int64)
        vals = np.cumsum(rng.integers(0, 20, n)).astype(np.float64)
        if i % 3 == 0:
            vals[n // 2:] -= vals[n // 2]
        per.append([(dp.encode_ts_page(ts[a : a + 400]),
                     dp.encode_f32_page(vals[a : a + 400]),
                     len(ts[a : a + 400])) for a in range(0, n, 400)])
    return pack_series_pages(per, 0)[0]


@pytest.mark.parametrize("n", [100, 250, 720])
@pytest.mark.parametrize("kind", ["rate", "increase", "delta"])
def test_b3_matches_plain(cuda, n, kind):
    packed = to_device(_packed(37, n, n), cuda)
    steps = torch.arange(60_000, n * 12_000, 60_000, dtype=torch.int32,
                         device=cuda)
    got = ck.fused_decode_rate(packed, steps, 300_000, kind, True)
    want = ck.fused_decode_rate_plain(packed, steps, 300_000, kind, True)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6,
                               equal_nan=True)


def test_b3_raises_past_shared_memory(cuda):
    packed = to_device(_packed(1, 128 * 128, 0), cuda)
    assert packed[0].shape[1] >= 128
    with pytest.raises(ValueError, match="shared memory"):
        ck.fused_decode_rate(packed, torch.zeros(1, dtype=torch.int32,
                                                 device=cuda), 300_000)


def test_b4_bitwise_equal_to_plain(cuda):
    rng = np.random.default_rng(3)
    P, S = 300, 1024
    ts = np.full((P, S), ck.TS_PAD, np.int32)
    vals = np.zeros((P, S), np.float32)
    for p in range(P):
        k = int(rng.integers(1, S))
        ts[p, :k] = np.cumsum(rng.integers(5_000, 15_000, k))
        vals[p, :k] = rng.normal(50, 10, k)
        hole = rng.choice(k, k // 4, replace=False)
        ts[p, hole], vals[p, hole] = ck.TS_PAD, 0.0
    steps = torch.arange(0, 6_000_000, 60_000, dtype=torch.int32)
    t, v = torch.from_numpy(ts), torch.from_numpy(vals)
    want = ck.windowed_sum(t, v, steps, 300_000)
    got = ck.windowed_sum(t.to(cuda), v.to(cuda), steps.to(cuda),
                          300_000).cpu()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_query_on_card_equals_cpu(cuda):
    rng = np.random.default_rng(1)
    n, T = 300, 720
    ts = 1_600_000_000_000 + np.arange(T) * 10_000 \
        + rng.integers(-500, 501, (n, T))
    vals = np.cumsum(rng.integers(0, 20, (n, T)), axis=1).astype(float)
    labels = [{"_metric_": "m", "_ws_": "w", "_ns_": f"ns-{i % 7}",
               "instance": f"i-{i}", "job": f"j-{i % 3}"} for i in range(n)]
    store = MemStore(4, 1, 400)
    store.ingest_series(labels, ts, vals)
    gpu, cpu = QueryService(store, cuda), QueryService(store, "cpu")
    for q in ("sum(rate(m[5m])) by (_ns_)", "delta(m[5m])",
              "max(sum_over_time(m[2m])) by (job)",
              "avg(avg_over_time(m[5m]))", "count(count_over_time(m[1m]))"):
        a = gpu.query_range(q, 1_600_000_000, 60, 1_600_007_200)
        b = cpu.query_range(q, 1_600_000_000, 60, 1_600_007_200)
        assert [str(k) for k in a.result.keys] == \
            [str(k) for k in b.result.keys]
        np.testing.assert_allclose(a.result.values, b.result.values,
                                   rtol=2e-5, atol=1e-6, equal_nan=True)
