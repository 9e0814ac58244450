"""Device pages: bit-packed columns that decode on the card.

Port of ``filodb_tpu/memory/device_pages.py``. A column is cut into fixed
128-value blocks with a per-block bit width, so decode is shifts and masks
with no data-dependent control flow.

Timestamp blocks (delta-delta): base i64, slope i32, width w; the 128
zigzag residuals of ``ts - (base + slope*i)`` are bit-packed into
``ceil(128*w/32)`` u32 words, padded to 128 words a block.

Float blocks (XOR against the block's first value, float32 lanes): first
u32 bit pattern, trailing-zero shift tz (in the slope slot), width w; the
128 ``(bits ^ first) >> tz`` fields are bit-packed the same way.

The encoders run many blocks a call in the host C++ codec
(``csrc/hostcodec.cpp``; the reference packs one value at a time in
Python, which cannot encode the hundreds of millions of samples of a real
store, and a page-in after a restart encodes every chunk it reads); their
numpy twins (``encode_ts_blocks_py``, ``encode_f32_blocks_py``) vectorise
the same arithmetic, and the tests hold both byte-equal to the
reference's. Words travel as int32 tensors holding the u32 bits, because
torch's uint32 supports few operations; the kernels read them as
``uint32_t``.

Decode: ``decode_ts_blocks`` (kernel B1) and ``decode_f32_blocks`` (kernel
B2) launch ``csrc/decode_pages.cu`` on a CUDA tensor and run their plain
versions (``*_plain``, integer arithmetic in int64) on a CPU tensor. The
kernels load words and store outputs 16 bytes a lane, so on the card
``words`` must start on a 16-byte boundary (every row slice of a packed
batch does: rows are 512 bytes); a misaligned view raises ``ValueError``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from filodb_tpu_torch import _build

BLOCK = 128
WORDS_PER_BLOCK_MAX = BLOCK  # at w=32: 128*32/32


@dataclass
class DevicePage:
    """One column encoded for device decode (the reference's layout)."""

    n: int                      # valid values
    kind: str                   # "ts" | "f32"
    bases: np.ndarray           # ts: int64 [nb]; f32: uint32 [nb]
    slopes: np.ndarray          # ts: int32 [nb]; f32: trailing-zero shifts
    widths: np.ndarray          # int32 [nb], bits per packed value
    words: np.ndarray           # uint32 [nb, 128]

    @property
    def num_blocks(self) -> int:
        return len(self.bases)


# ---------------------------------------------------------------------------
# vectorised encoders


def _bit_length(x: np.ndarray) -> np.ndarray:
    """Bit length of non-negative integers below 2**53, elementwise."""
    return np.frexp(x.astype(np.float64))[1].astype(np.int32)


_PACK_PLANS: dict[int, tuple] = {}


def _pack_plan(w: int):
    """Per-width constants: each lane's bit offset inside its first word,
    and 0/1 matrices sending lane parts to their words."""
    plan = _PACK_PLANS.get(w)
    if plan is None:
        bit0 = np.arange(BLOCK, dtype=np.int64) * w
        word, off = bit0 >> 5, bit0 & 31
        nwords = -(-BLOCK * w // 32)
        to_lo = np.zeros((BLOCK, nwords), np.float64)
        to_lo[np.arange(BLOCK), word] = 1.0
        to_hi = np.zeros((BLOCK, nwords), np.float64)
        spill = word + 1 < nwords
        to_hi[np.arange(BLOCK)[spill], word[spill] + 1] = 1.0
        plan = _PACK_PLANS[w] = (off.astype(np.uint64), to_lo, to_hi)
    return plan


def pack_blocks(vals: np.ndarray, widths: np.ndarray) -> np.ndarray:
    """Bit-pack each row of uint32 ``vals`` [nb, 128] at its row's width:
    lane i fills bits [i*w, i*w+w) of the row's u32 words → [nb, 128].

    Rows are grouped by width. Within a group the fields never overlap, so
    each word is the sum of the field parts that land in it: a product with
    a 0/1 matrix, exact in float64 because every sum stays below 2**32."""
    out = np.zeros((vals.shape[0], BLOCK), np.uint32)
    for w in np.unique(widths):
        w = int(w)
        if w == 0:
            continue
        rows = np.flatnonzero(widths == w)
        off, to_lo, to_hi = _pack_plan(w)
        mask = np.uint64(0xFFFFFFFF if w >= 32 else (1 << w) - 1)
        shifted = (vals[rows].astype(np.uint64) & mask) << off
        lo = (shifted & np.uint64(0xFFFFFFFF)).astype(np.float64)
        hi = (shifted >> np.uint64(32)).astype(np.float64)
        out[rows, : to_lo.shape[1]] = (lo @ to_lo + hi @ to_hi).astype(
            np.uint32)
    return out


def encode_ts_blocks(ts: np.ndarray, n: np.ndarray):
    """Delta-delta encode blocks: ``ts`` int64 [nb, 128] (lanes past
    ``n[b]`` ignored), ``n`` valid lanes a block → (bases, slopes, widths,
    words) as the reference's ``encode_ts_page`` lays each block out. Runs
    the host C++ codec; ``encode_ts_blocks_py`` is its numpy twin."""
    ts = np.ascontiguousarray(ts, np.int64)
    n = np.ascontiguousarray(n, np.int64)
    nb = len(n)
    base = np.zeros(nb, np.int64)
    slope = np.zeros(nb, np.int32)
    width = np.zeros(nb, np.int32)
    words = np.zeros((nb, BLOCK), np.uint32)
    if nb and _build.host_fn("fh_encode_ts_blocks", 7)(
            ts.ctypes.data, n.ctypes.data, nb, base.ctypes.data,
            slope.ctypes.data, width.ctypes.data, words.ctypes.data):
        raise ValueError("residual too large for a ts page")
    return base, slope, width, words


def encode_f32_blocks(vals: np.ndarray, n: np.ndarray):
    """XOR-vs-block-first encode blocks of float32 values [nb, 128] →
    (firsts u32, shifts i32, widths i32, words u32), as the reference's
    ``encode_f32_page`` lays each block out. Runs the host C++ codec;
    ``encode_f32_blocks_py`` is its numpy twin."""
    bits = np.ascontiguousarray(vals, np.float32).view(np.uint32)
    n = np.ascontiguousarray(n, np.int64)
    nb = len(n)
    first = np.zeros(nb, np.uint32)
    shift = np.zeros(nb, np.int32)
    width = np.zeros(nb, np.int32)
    words = np.zeros((nb, BLOCK), np.uint32)
    if nb:
        _build.host_fn("fh_encode_f32_blocks", 7)(
            bits.ctypes.data, n.ctypes.data, nb, first.ctypes.data,
            shift.ctypes.data, width.ctypes.data, words.ctypes.data)
    return first, shift, width, words


def encode_ts_blocks_py(ts: np.ndarray, n: np.ndarray):
    """Numpy twin of ``encode_ts_blocks``."""
    ts = np.asarray(ts, np.int64)
    n = np.asarray(n, np.int64)
    nb = ts.shape[0]
    lane = np.arange(BLOCK, dtype=np.int64)[None, :]
    valid = lane < n[:, None]
    has = n > 0
    base = np.where(has, ts[:, 0], 0)
    last = ts[np.arange(nb), np.maximum(n - 1, 0)]
    slope = np.where(has, (last - base) // np.maximum(n - 1, 1), 0)
    resid = ts - (base[:, None] + slope[:, None] * lane)
    zz = np.where(valid, (resid << 1) ^ (resid >> 63), 0).astype(np.uint64)
    if (zz >= 2**32).any():
        raise ValueError("residual too large for a ts page")
    zz32 = zz.astype(np.uint32)
    widths = _bit_length(zz32.max(axis=1, initial=0))
    return (base.astype(np.int64), slope.astype(np.int32), widths,
            pack_blocks(zz32, widths))


def encode_f32_blocks_py(vals: np.ndarray, n: np.ndarray):
    """Numpy twin of ``encode_f32_blocks``."""
    bits = np.ascontiguousarray(vals, np.float32).view(np.uint32)
    n = np.asarray(n, np.int64)
    lane = np.arange(BLOCK, dtype=np.int64)[None, :]
    valid = lane < n[:, None]
    first = np.where(n > 0, bits[:, 0], 0).astype(np.uint32)
    xored = np.where(valid, bits ^ first[:, None], 0).astype(np.uint32)
    # the block's shift is the least trailing-zero count of its nonzero
    # fields: the trailing zeros of their OR (32 when every field is 0)
    anyx = np.bitwise_or.reduce(xored, axis=1)
    low = anyx & (~anyx + np.uint32(1))
    tz = np.where(anyx != 0, _bit_length(low) - 1, 32).astype(np.int32)
    shifted = xored >> (tz[:, None] % 32).astype(np.uint32)
    widths = _bit_length(shifted.max(axis=1, initial=0))
    tz = np.where(n > 0, tz, 0).astype(np.int32)  # empty blocks stay zero
    return first, tz, widths, pack_blocks(shifted, widths)


def _blocks_of(x: np.ndarray, fill):
    n = len(x)
    nb = max(-(-n // BLOCK), 1)
    out = np.full(nb * BLOCK, fill, x.dtype)
    out[:n] = x
    counts = np.clip(n - np.arange(nb) * BLOCK, 0, BLOCK)
    return out.reshape(nb, BLOCK), counts


def encode_ts_page(ts: np.ndarray) -> DevicePage:
    """Delta-delta encode one timestamp column."""
    ts = np.ascontiguousarray(ts, np.int64)
    blocks, counts = _blocks_of(ts, 0)
    return DevicePage(len(ts), "ts", *encode_ts_blocks(blocks, counts))


def encode_f32_page(vals: np.ndarray) -> DevicePage:
    """XOR-vs-block-first encode one float column (cast to float32)."""
    v = np.ascontiguousarray(vals, np.float32)
    blocks, counts = _blocks_of(v, 0)
    return DevicePage(len(v), "f32", *encode_f32_blocks(blocks, counts))


# ---------------------------------------------------------------------------
# decode: kernels B1/B2 and their plain versions


def u32_as_i32(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy bits → int32 tensor holding the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 → int32 with two's-complement wrap-around."""
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def unpack_plain(words: torch.Tensor, widths: torch.Tensor) -> torch.Tensor:
    """Width-w fields of each block's words (int32 bits [nb, 128]) as int64
    in [0, 2**32): lane i reads bits [i*w, i*w+w)."""
    wd = words.to(torch.int64) & 0xFFFFFFFF
    w = widths.to(torch.int64)[:, None]
    bit0 = torch.arange(BLOCK, dtype=torch.int64, device=words.device) * w
    idx = bit0 >> 5
    off = bit0 & 31
    lo = torch.gather(wd, 1, idx.clamp(max=WORDS_PER_BLOCK_MAX - 1))
    hi = torch.gather(wd, 1, (idx + 1).clamp(max=WORDS_PER_BLOCK_MAX - 1))
    val = (lo >> off) | torch.where(off > 0, (hi << (32 - off)) & 0xFFFFFFFF,
                                    0)
    mask = torch.where(w >= 32, 0xFFFFFFFF, (1 << w.clamp(max=32)) - 1)
    return torch.where(w == 0, 0, val & mask)


def decode_ts_blocks_plain(slopes, widths, words) -> torch.Tensor:
    zz = unpack_plain(words, widths)
    resid = (zz >> 1) ^ -(zz & 1)
    lane = torch.arange(BLOCK, dtype=torch.int64, device=words.device)
    return _wrap_i32(slopes.to(torch.int64)[:, None] * lane + resid)


def decode_f32_blocks_plain(firsts, shifts, widths, words) -> torch.Tensor:
    x = unpack_plain(words, widths)
    tz = shifts.to(torch.int64)[:, None]
    xored = torch.where(tz >= 32, 0, (x << tz.clamp(max=32)) & 0xFFFFFFFF)
    bits = xored ^ (firsts.to(torch.int64)[:, None] & 0xFFFFFFFF)
    return _wrap_i32(bits).view(torch.float32)


def _check_blocks(words: torch.Tensor, *scalars: torch.Tensor) -> None:
    if words.dtype != torch.int32 or words.dim() != 2 \
            or words.shape[1] != WORDS_PER_BLOCK_MAX:
        raise ValueError(f"words must be int32 [nb, {WORDS_PER_BLOCK_MAX}], "
                         f"got {words.dtype} {tuple(words.shape)}")
    for s in scalars:
        if s.dtype != torch.int32 or s.shape != words.shape[:1]:
            raise ValueError("per-block scalars must be int32 [nb]")
        if s.device != words.device:
            raise ValueError("all operands must be on one device")


def _check_aligned(**operands: torch.Tensor) -> None:
    """The kernels move words and outputs 16 bytes a lane."""
    for name, t in operands.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the decode "
                             f"kernel (data_ptr % 16 = {t.data_ptr() % 16})")


def decode_ts_blocks(slopes: torch.Tensor, widths: torch.Tensor,
                     words: torch.Tensor) -> torch.Tensor:
    """B1: int32 offsets from each block's base [nb, 128]."""
    _check_blocks(words, slopes, widths)
    if words.device.type == "cpu":
        return decode_ts_blocks_plain(slopes, widths, words)
    slopes, widths, words = (t.contiguous() for t in (slopes, widths, words))
    out = torch.empty(words.shape, dtype=torch.int32, device=words.device)
    _check_aligned(words=words, out=out)
    fn = _build.bind("decode_pages", "decode_ts_pages", 6)
    with torch.cuda.device(words.device):  # launches on the current device
        _build.check("decode_pages", fn(
            slopes.data_ptr(), widths.data_ptr(), words.data_ptr(),
            out.data_ptr(), words.shape[0],
            torch.cuda.current_stream(words.device).cuda_stream))
    _build.count("decode_ts_page")
    return out


def decode_f32_blocks(firsts: torch.Tensor, shifts: torch.Tensor,
                      widths: torch.Tensor,
                      words: torch.Tensor) -> torch.Tensor:
    """B2: float32 values [nb, 128] (firsts are int32 holding u32 bits)."""
    _check_blocks(words, firsts, shifts, widths)
    if words.device.type == "cpu":
        return decode_f32_blocks_plain(firsts, shifts, widths, words)
    firsts, shifts, widths, words = (
        t.contiguous() for t in (firsts, shifts, widths, words))
    out = torch.empty(words.shape, dtype=torch.float32, device=words.device)
    _check_aligned(words=words, out=out)
    fn = _build.bind("decode_pages", "decode_f32_pages", 7)
    with torch.cuda.device(words.device):  # launches on the current device
        _build.check("decode_pages", fn(
            firsts.data_ptr(), shifts.data_ptr(), widths.data_ptr(),
            words.data_ptr(), out.data_ptr(), words.shape[0],
            torch.cuda.current_stream(words.device).cuda_stream))
    _build.count("decode_f32_page")
    return out
