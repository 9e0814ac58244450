"""Port parity: device-page encoders and the plain versions of kernels B1
(timestamp decode) and B2 (float decode) against the JAX package.

The encoders must be byte-equal to ``filodb_tpu.memory.device_pages``'s;
the plain decoders bitwise equal to the Pallas kernels in interpret mode.
"""

import numpy as np
import pytest
import torch

import filodb_tpu.memory.device_pages as ref
from filodb_tpu.query.engine.device_batch import (
    pack_series_pages as ref_pack_series_pages,
)
from filodb_tpu_torch.memory import device_pages as port
from filodb_tpu_torch.query.engine import device_batch as port_batch

PAGE_FIELDS = ("bases", "slopes", "widths", "words")


def _ts(n, jitter, seed):
    rng = np.random.default_rng(seed)
    return (np.arange(n, dtype=np.int64) * 10_000
            + rng.integers(-jitter, jitter + 1, n) + 1_600_000_000_000)


def _vals(n, seed, special=False):
    rng = np.random.default_rng(seed)
    v = np.cumsum(rng.integers(0, 20, n)).astype(np.float64)
    if special and n >= 8:
        v[[1, 3, 4, 5, 7]] = [np.nan, np.inf, -np.inf, -0.0, 2.5e-45]
    return v


def _assert_pages_equal(a, b):
    for f in PAGE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f
    assert a.n == b.n and a.kind == b.kind


@pytest.mark.parametrize("n", [0, 1, 7, 127, 128, 129, 400, 1000])
@pytest.mark.parametrize("jitter", [0, 1, 500, 2_000_000])
def test_encode_ts_page_byte_equal(n, jitter):
    ts = _ts(n, jitter, seed=n + jitter)
    _assert_pages_equal(ref.encode_ts_page(ts), port.encode_ts_page(ts))


@pytest.mark.parametrize("n", [0, 1, 8, 128, 300, 1000])
@pytest.mark.parametrize("special", [False, True])
def test_encode_f32_page_byte_equal(n, special):
    v = _vals(n, seed=n, special=special)
    _assert_pages_equal(ref.encode_f32_page(v), port.encode_f32_page(v))


def test_encode_f32_random_bits_byte_equal():
    # arbitrary bit patterns reach every width up to 32 and tz 0..32
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2**32, 640, dtype=np.uint64).astype(np.uint32)
    bits[128:256] = bits[128]  # constant block: w = 0, tz = 32
    bits[256:384] = (bits[256:384] >> 20) << 20  # trailing zeros: tz >= 20
    v = bits.view(np.float32)
    _assert_pages_equal(ref.encode_f32_page(v), port.encode_f32_page(v))


def _width_words(rng, nb):
    """Blocks of every width 0..32, then ``nb`` more cycling through 0, 1,
    31 and 32, with random words across the whole row (past 4*w too)."""
    widths = np.concatenate([np.arange(33), [0, 1, 31, 32] * nb])[
        : 33 + nb].astype(np.int32)
    words = rng.integers(0, 2**32, (len(widths), 128),
                         dtype=np.uint64).astype(np.uint32)
    return widths, words


@pytest.mark.parametrize("nb", [4, 9])
def test_b1_plain_bitwise_equal_to_pallas(nb):
    import jax.numpy as jnp

    rng = np.random.default_rng(nb)
    widths, words = _width_words(rng, nb)
    slopes = rng.integers(-20_000, 20_000, len(widths)).astype(np.int32)
    want = np.asarray(ref.decode_ts_page_pallas(
        jnp.asarray(slopes), jnp.asarray(widths), jnp.asarray(words),
        interpret=True))
    got = port.decode_ts_blocks(torch.from_numpy(slopes),
                                torch.from_numpy(widths),
                                port.u32_as_i32(words)).numpy()
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("nb", [4, 9])
def test_b2_plain_bitwise_equal_to_pallas(nb):
    import jax.numpy as jnp

    rng = np.random.default_rng(100 + nb)
    widths, words = _width_words(rng, nb)
    # every shift 0..32 (5 is prime to 33)
    shifts = (np.arange(len(widths)) * 5 % 33).astype(np.int32)
    firsts = rng.integers(0, 2**32, len(widths),
                          dtype=np.uint64).astype(np.uint32)
    want = np.asarray(ref.decode_f32_page_pallas(
        jnp.asarray(firsts), jnp.asarray(shifts), jnp.asarray(widths),
        jnp.asarray(words), interpret=True))
    got = port.decode_f32_blocks(port.u32_as_i32(firsts),
                                 torch.from_numpy(shifts),
                                 torch.from_numpy(widths),
                                 port.u32_as_i32(words)).numpy()
    assert got.view(np.uint32).tobytes() == want.view(np.uint32).tobytes()


@pytest.mark.parametrize("w", range(33))
def test_b1_b2_plain_ignore_words_past_4w(w):
    # a block of width w keeps its 128 fields in its first 4*w words; the
    # decode kernels read past them and rely on the width mask, so the
    # plain versions they are held to must not see those words either
    rng = np.random.default_rng(w)
    nb = 33
    words = rng.integers(0, 2**32, (nb, 128), dtype=np.uint64).astype(
        np.uint32)
    other = words.copy()
    other[:, 4 * w:] = rng.integers(0, 2**32, (nb, 128 - 4 * w),
                                    dtype=np.uint64).astype(np.uint32)
    widths = torch.full((nb,), w, dtype=torch.int32)
    slopes = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, nb).astype(
        np.int32))
    shifts = torch.arange(nb, dtype=torch.int32)  # every shift 0..32
    firsts = port.u32_as_i32(rng.integers(0, 2**32, nb, dtype=np.uint64)
                             .astype(np.uint32))
    ts = [port.decode_ts_blocks(slopes, widths, port.u32_as_i32(x))
          for x in (words, other)]
    fs = [port.decode_f32_blocks(firsts, shifts, widths, port.u32_as_i32(x))
          .view(torch.int32) for x in (words, other)]
    assert torch.equal(ts[0], ts[1]) and torch.equal(fs[0], fs[1])


@pytest.mark.parametrize("n", [5, 300])
def test_round_trip_through_encoders_and_plain_decoders(n):
    import jax.numpy as jnp

    ts = _ts(n, 500, seed=2)
    v = _vals(n, seed=3, special=True)
    tp, vp = port.encode_ts_page(ts), port.encode_f32_page(v)
    off = port.decode_ts_blocks(torch.from_numpy(tp.slopes),
                                torch.from_numpy(tp.widths),
                                port.u32_as_i32(tp.words)).numpy()
    got_ts = (tp.bases[:, None] + off.astype(np.int64)).ravel()[:n]
    np.testing.assert_array_equal(got_ts, ts)
    got_v = port.decode_f32_blocks(port.u32_as_i32(vp.bases),
                                   torch.from_numpy(vp.slopes),
                                   torch.from_numpy(vp.widths),
                                   port.u32_as_i32(vp.words)).numpy()
    want = np.asarray(ref.decode_f32_page_pallas(
        *(jnp.asarray(a) for a in (vp.bases, vp.slopes, vp.widths,
                                   vp.words)), interpret=True))
    assert got_v.view(np.uint32).tobytes() == want.view(np.uint32).tobytes()
    np.testing.assert_array_equal(got_v.ravel()[:n], v.astype(np.float32))


def test_pack_series_pages_byte_equal():
    per_ref, per_port = [], []
    for i, sizes in enumerate([[400, 320], [129], [], [400, 400, 1]]):
        er, ep = [], []
        t0 = 0
        for j, n in enumerate(sizes):
            ts = _ts(n, 500, seed=10 * i + j) + t0
            t0 += n * 10_000
            v = _vals(n, seed=10 * i + j)
            er.append((ref.encode_ts_page(ts), ref.encode_f32_page(v), n))
            ep.append((port.encode_ts_page(ts), port.encode_f32_page(v), n))
        per_ref.append(er)
        per_port.append(ep)
    start = 1_600_000_000_000 - 300_000
    want, wcounts = ref_pack_series_pages(per_ref, start)
    got, gcounts = port_batch.pack_series_pages(per_port, start)
    assert len(want) == len(got) == 9
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(wcounts, gcounts)
