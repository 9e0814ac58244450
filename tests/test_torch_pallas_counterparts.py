"""Port parity: the plain versions of kernels B3 (fused decode → rate) and
B4 (windowed sum) against the JAX package's Pallas kernels in interpret
mode. Tolerances are the reference's own: B3 ``rtol=2e-5, atol=1e-6``
with NaN where a window holds < 2 samples (``tests/test_pallas_fused.py``),
B4 ``rtol=1e-5`` and exact 0.0 for empty windows
(``tests/test_device_pages.py``).
"""

import numpy as np
import pytest
import torch

import filodb_tpu.memory.device_pages as ref_pages
from filodb_tpu.query.engine.device_batch import (
    pack_series_pages as ref_pack,
)
from filodb_tpu.query.engine.pallas_kernels import (
    fused_decode_rate_pallas,
    windowed_sum_pallas,
)
from filodb_tpu_torch.memory import device_pages as port_pages
from filodb_tpu_torch.query.engine import cuda_kernels
from filodb_tpu_torch.query.engine.device_batch import (
    pack_series_pages as port_pack,
)
from filodb_tpu_torch.query.engine.device_batch import to_device

CHUNK = 400


def _series(n, seed, reset_at=None, counter=True):
    rng = np.random.default_rng(seed)
    ts = np.cumsum(rng.integers(8000, 12000, n)).astype(np.int64)
    if counter:
        vals = np.cumsum(rng.integers(0, 20, n)).astype(np.float64)
        if reset_at is not None:
            vals[reset_at:] -= vals[reset_at]
    else:
        vals = rng.integers(-50, 50, n).astype(np.float64)
    return ts, vals


def _packed(specs, counter=True, seed=0):
    """The same series packed by the reference and by the port, each series
    cut into chunks of ``CHUNK`` samples as the stores seal them."""
    per_ref, per_port = [], []
    for i, (n, reset_at) in enumerate(specs):
        ts, vals = _series(n, seed + i, reset_at, counter)
        er, ep = [], []
        for c in range(0, n, CHUNK):
            t, v = ts[c : c + CHUNK], vals[c : c + CHUNK]
            er.append((ref_pages.encode_ts_page(t),
                       ref_pages.encode_f32_page(v), len(t)))
            ep.append((port_pages.encode_ts_page(t),
                       port_pages.encode_f32_page(v), len(t)))
        per_ref.append(er)
        per_port.append(ep)
    return ref_pack(per_ref, 0)[0], port_pack(per_port, 0)[0]


SPECS = {
    1: [(100, None), (120, 60), (17, None), (1, None)],
    2: [(150, None), (240, 200), (130, 3)],
    8: [(800, None), (780, 450), (700, 401), (600, None), (30, None)],
    # 17 chunks of 400 samples, 4 blocks each: the long series the
    # streaming kernel takes and the one-CTA kernel refused
    128: [(6800, None), (6500, 3001), (6600, 512), (100, None)],
}


@pytest.mark.parametrize("nb", sorted(SPECS))
@pytest.mark.parametrize("kind,counter", [("rate", True),
                                          ("increase", True),
                                          ("delta", False)])
def test_b3_plain_matches_fused_pallas(nb, kind, counter):
    import jax.numpy as jnp

    want_packed, got_packed = _packed(SPECS[nb], counter=counter, seed=nb)
    assert got_packed[0].shape[1] == nb
    span = max(n for n, _ in SPECS[nb]) * 12_000
    steps = np.linspace(100_000, span, 9).astype(np.int32)
    window = 300_000
    want = np.asarray(fused_decode_rate_pallas(
        tuple(jnp.asarray(a) for a in want_packed), jnp.asarray(steps),
        jnp.asarray(np.int32(window)), kind=kind, counter=counter,
        interpret=True))
    got = cuda_kernels.fused_decode_rate(
        to_device(got_packed, torch.device("cpu")), torch.from_numpy(steps),
        window, kind=kind, counter=counter).numpy()
    n = len(SPECS[nb])
    assert np.isnan(want[:n]).any() and not np.isnan(want[:n]).all()
    np.testing.assert_allclose(got[:n], want[:n], rtol=2e-5, atol=1e-6,
                               equal_nan=True)


def test_b3_empty_windows_are_nan():
    _, got_packed = _packed([(100, None)])
    steps = torch.tensor([10**9, 2 * 10**9], dtype=torch.int32)
    got = cuda_kernels.fused_decode_rate(
        to_device(got_packed, torch.device("cpu")), steps, 300_000)
    assert torch.isnan(got[0]).all()


def _sum_inputs(seed, P=5, S=256, gaps=False, span=15_000):
    rng = np.random.default_rng(seed)
    ts = np.full((P, S), cuda_kernels.TS_PAD, np.int32)
    vals = np.zeros((P, S), np.float32)
    for p in range(P):
        n = int(rng.integers(S // 2, S))
        ts[p, :n] = np.cumsum(rng.integers(5_000, span, n))
        vals[p, :n] = rng.normal(50, 10, n)
        if gaps:  # interior padded lanes, as assemble leaves between chunks
            hole = rng.choice(n, n // 5, replace=False)
            ts[p, hole] = cuda_kernels.TS_PAD
            vals[p, hole] = 0.0
    return ts, vals


@pytest.mark.parametrize("gaps", [False, True])
@pytest.mark.parametrize("window", [60_000, 300_000])
def test_b4_plain_matches_windowed_sum_pallas(gaps, window):
    import jax.numpy as jnp

    ts, vals = _sum_inputs(seed=window // 1000 + gaps, gaps=gaps)
    steps = np.arange(0, 3_000_000, 90_000, dtype=np.int32)
    want = np.asarray(windowed_sum_pallas(
        jnp.asarray(ts), jnp.asarray(vals), jnp.asarray(steps),
        jnp.asarray(np.int32(window)), interpret=True))
    got = cuda_kernels.windowed_sum(torch.from_numpy(ts),
                                    torch.from_numpy(vals),
                                    torch.from_numpy(steps), window).numpy()
    empty = want == 0.0
    assert empty.any() and not empty.all()
    np.testing.assert_allclose(got[~empty], want[~empty], rtol=1e-5)
    assert (got[empty] == 0.0).all()


def test_b4_plain_matches_windowed_sum_pallas_on_long_rows():
    """S = 32,768 samples a row (48 h at 10 s padded to 256 blocks)."""
    import jax.numpy as jnp

    ts, vals = _sum_inputs(seed=11, P=3, S=32768, gaps=True, span=11_000)
    steps = np.arange(0, 2_880 * 60_000 + 1, 60_000, dtype=np.int32)
    want = np.asarray(windowed_sum_pallas(
        jnp.asarray(ts), jnp.asarray(vals), jnp.asarray(steps),
        jnp.asarray(np.int32(300_000)), interpret=True))
    got = cuda_kernels.windowed_sum(torch.from_numpy(ts),
                                    torch.from_numpy(vals),
                                    torch.from_numpy(steps), 300_000).numpy()
    empty = want == 0.0
    assert empty.any() and not empty.all()
    np.testing.assert_allclose(got[~empty], want[~empty], rtol=1e-5)
    assert (got[empty] == 0.0).all()


@pytest.mark.parametrize("step,window,want", [
    (60_000, 300_000, 5),
    (60_000, 3_600_000, 60),
    (60_000, 3_600_001, 61),
    (7_000, 300_000, 43),
    (60_000, 1_000, 1),
    (60_000, 0, 0),
])
def test_steps_in_flight(step, window, want):
    steps = torch.arange(0, 2_881 * step, step, dtype=torch.int32)
    assert cuda_kernels.steps_in_flight(steps, window) == want
    assert cuda_kernels.steps_in_flight(steps[:1], window) == min(want, 1)


def test_steps_in_flight_takes_only_sorted_steps():
    with pytest.raises(ValueError, match="non-decreasing"):
        cuda_kernels.steps_in_flight(
            torch.tensor([3, 1, 2], dtype=torch.int32), 10)
    assert cuda_kernels.steps_in_flight(
        torch.tensor([5, 5, 5], dtype=torch.int32), 1) == 3


def test_b4_plain_adds_in_sample_order():
    # float32 sums that depend on order: the plain version must add in
    # sample order, as the kernel does
    ts = np.array([[1, 2, 3, 4]], np.int32)
    vals = np.array([[1e8, 1.0, -1e8, 1.0]], np.float32)
    got = cuda_kernels.windowed_sum(torch.from_numpy(ts),
                                    torch.from_numpy(vals),
                                    torch.tensor([4], dtype=torch.int32), 10)
    want = np.float32(0.0)
    for x in vals[0]:
        want = np.float32(want + x)
    assert got.item() == want


def test_wrappers_reject_bad_operands():
    ts, vals = _sum_inputs(seed=1)
    with pytest.raises(ValueError):
        cuda_kernels.windowed_sum(torch.from_numpy(ts).long(),
                                  torch.from_numpy(vals),
                                  torch.tensor([1], dtype=torch.int32), 10)
    with pytest.raises(ValueError):
        cuda_kernels.fused_decode_rate(
            to_device(_packed([(10, None)])[1], torch.device("cpu"))[:8],
            torch.tensor([1], dtype=torch.int32), 10)
