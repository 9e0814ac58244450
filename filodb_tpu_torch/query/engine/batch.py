"""The host-decode lane: batches of float64 samples decoded from codec chunks.

Port of ``filodb_tpu/query/engine/batch.py``, the reference's default lane
(``StoreConfig(device_pages=False)``). The port's page lane reads float32
device pages; a batch whose selected values float32 cannot hold exactly
(every chunk and write buffer carries the flag,
``partition.exact_in_f32``) comes here instead, so that its answers are
the reference's float64 ones.

``Shard.select_for_batch`` gathers a shard's part under its lock
(``Samples``): the codec chunks of the selected chunks (held until their
flush, paged in, or read back from the column store) and copies of the
write buffers that overlap the range. ``build_batch`` then decodes every
codec chunk with the host C++ codec (``memory/chunk.py::decode_chunks``),
uploads the decoded blocks and lays the rows out on the card, vectorised
over the blocks: NaN samples and samples outside [start, end] dropped, a
series' chunks in chunk-id order, then its write buffer. Unlike the
reference's, P and S are not padded to powers of two (it pads to feed
XLA's compile caches).

``SeriesBatch`` holds ts int32 [P, S] relative to ``base`` (``TS_PAD``
past a series' samples), vals float64 [P, S] (NaN there), counts, keys
and ``is_counter``, on the card. ``delta_host`` is the reference's
float64 counter-reset correction and rebase to each series' first value
(``rebased``); ``delta_arrays`` makes the same values on the card, where
the batch lives, once a ``counter`` setting (the corrections add one
after another, as ``np.cumsum`` adds, on either device: the same bits),
and hands them out beside the raw values, which the extrapolation clamp
of rate and increase reads. The service's ``BatchCache`` holds these
batches as it holds page batches.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from filodb_tpu_torch.core.schemas import Schema
from filodb_tpu_torch.memory.chunk import (
    ChunkBytes,
    bucket_counts,
    decode_chunks,
)
from filodb_tpu_torch.query.engine.kernels import running_sum

TS_PAD = np.iinfo(np.int32).max
_REBASE_SAMPLES = 1 << 25  # samples ``rebased`` takes at once


def rebased(vals: torch.Tensor, counts: torch.Tensor,
            counter: bool) -> torch.Tensor:
    """The reference's ``SeriesBatch.delta_host`` on ``vals`` [P, S]
    float64 (NaN past each row's ``counts`` samples) on their device:
    counter-reset corrected where ``counter`` (a drop below the previous
    sample adds that sample to every later one), then rebased by each
    row's first value; NaN past a row's samples. Rows go in chunks of
    ``_REBASE_SAMPLES`` samples."""
    P, S = vals.shape
    rows = max(1, _REBASE_SAMPLES // max(S, 1))
    return torch.cat([_rebased(vals[a:a + rows], counts[a:a + rows], counter)
                      for a in range(0, P, rows)] or [vals])


def _rebased(vals, counts, counter: bool) -> torch.Tensor:
    valid = ~torch.isnan(vals)
    v = torch.where(valid, vals, 0.0)
    if counter:
        prev = torch.cat([v[:, :1], v[:, :-1]], 1)
        pvalid = torch.cat([torch.zeros_like(valid[:, :1]), valid[:, :-1]], 1)
        dropped = (v < prev) & valid & pvalid
        v = v + running_sum(torch.where(dropped, prev, 0.0))
    # samples lie from column 0 on: the first is column 0
    base = torch.where(counts > 0, v[:, 0], 0.0)
    return torch.where(valid, v - base[:, None], float("nan"))


@dataclass
class Samples:
    """A shard's part of a host-lane batch, gathered under its lock. Rows
    are batch rows (a partition's index in the shard's selection).

    ``codec``: (``ChunkBytes`` of ``schema``, rows [C], chunk ids [C]),
    decoded by ``build_batch`` into the DOUBLE column ``column`` of the
    schema; ``decoded``: samples already in hand, (rows [N], late [N],
    chunk ids [N], ts int64 [N, M], vals float64 [N, M], live bool [N,
    M]): copies of the write buffers (late 1: after the chunks), and the
    page values of chunks whose codec the store no longer holds."""

    schema: Schema
    column: int
    codec: list = field(default_factory=list)
    decoded: list = field(default_factory=list)


@dataclass
class SeriesBatch:
    """P series with up to S samples each, float64, rows in selection
    order, on the batch's device; timestamps relative to ``base``, the
    batch's data range [base, end]."""

    keys: list             # RangeVectorKey per series (metric kept)
    ts: torch.Tensor       # int32 [P, S], TS_PAD past a series' samples
    vals: torch.Tensor     # float64 [P, S], NaN past them
    counts: np.ndarray     # int32 [P]: in-range non-NaN samples (host)
    is_counter: bool
    base: int
    end: int
    version: int = 0       # the owner's version the batch is valid at
    les = None             # a host-lane batch holds scalar series only
    # seconds of the build (select and decode: the host's; upload and
    # layout: the device's, synchronised) and of each correct-and-rebase
    seconds: dict = field(default_factory=dict)
    _out_keys: list | None = None
    _counts: torch.Tensor | None = None
    _delta: dict = field(default_factory=dict)

    def __post_init__(self):
        self._counts = torch.from_numpy(self.counts).to(self.vals.device)

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def out_keys(self) -> list:
        """Series keys of a range function's output (metric dropped)."""
        if self._out_keys is None:
            self._out_keys = [k.drop_metric() for k in self.keys]
        return self._out_keys

    @property
    def nbytes(self) -> int:
        """Device bytes of the batch and of its rebased values."""
        return sum(t.numel() * t.element_size() for t in (
            self.ts, self.vals, self._counts, *self._delta.values()))

    def device_arrays(self) -> tuple:
        """(ts, vals, counts) on the batch's device."""
        return self.ts, self.vals, self._counts

    def delta_host(self, counter: bool) -> np.ndarray:
        """Values [P, S] float64 for the delta family (rate, increase,
        delta, irate, idelta, deriv) on the host, the reference's
        ``SeriesBatch.delta_host`` (``rebased``)."""
        return rebased(self.vals, self._counts, counter).cpu().numpy()

    def delta_arrays(self, counter: bool) -> tuple:
        """(ts, rebased vals, counts, raw vals) on the device: ``rebased``
        made there once a ``counter`` setting."""
        hit = self._delta.get(counter)
        if hit is None:
            t = time.perf_counter()
            hit = self._delta[counter] = rebased(self.vals, self._counts,
                                                 counter)
            _synchronize(self.device)
            self.seconds["rebase"] = self.seconds.get("rebase", 0.0) \
                + time.perf_counter() - t
        return self.ts, hit, self._counts, self.vals


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _decoded(cb: ChunkBytes, schema: Schema, column: int):
    """(positions in ``cb``, ts, vals, rows) of codec chunks decoded by the
    host codec: one decode a bucket count for a histogram schema."""
    if schema.is_histogram:
        nb = bucket_counts(cb, schema)
        groups = [np.flatnonzero(nb == b) for b in np.unique(nb).tolist()]
    else:
        groups = [np.arange(len(cb))]
    for g in groups:
        d = decode_chunks(cb.take(g), schema)
        yield g, d.ts, d.dcols[:, column], d.rows


def build_batch(parts: list[tuple[int, Samples]], n_rows: int, start: int,
                end: int, device: torch.device):
    """Lay the samples of ``parts`` ((first batch row, a shard's
    ``Samples``) each) out on ``device`` as ts int32 [P, S] relative to
    ``start`` and vals float64 [P, S], and count them (int32 [P], on the
    host): samples outside [start, end] and NaN samples dropped, a series'
    chunks in chunk-id order and then its write buffer. The codec chunks
    are decoded on the host; the decoded blocks go to the device, where
    the layout runs. → (ts, vals, counts, seconds of the decode, the upload
    and the layout)."""
    t = time.perf_counter()
    rows, late, cids, blocks = [], [], [], []
    for first, s in parts:
        for cb, r, c in s.codec:
            for g, ts, vals, n in _decoded(cb, s.schema, s.column):
                rows.append(r[g] + first)
                late.append(np.zeros(len(g), np.int64))
                cids.append(c[g])
                blocks.append((ts, vals, np.arange(ts.shape[1])[None, :]
                               < n[:, None]))
        for r, lt, c, ts, vals, live in s.decoded:
            rows.append(r + first)
            late.append(lt)
            cids.append(c)
            blocks.append((ts, vals, live))
    none = [np.zeros(0, np.int64)]
    row = np.concatenate(rows + none).astype(np.int64)
    order = np.lexsort((np.concatenate(cids + none),
                        np.concatenate(late + none), row))
    seconds = {"decode": time.perf_counter() - t}
    t = time.perf_counter()
    blocks = [tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                    for a in b) for b in blocks]
    row = torch.from_numpy(row).to(device)
    order = torch.from_numpy(order).to(device)
    _synchronize(device)
    seconds["upload"] = time.perf_counter() - t
    t = time.perf_counter()
    keep = [live & (ts >= start) & (ts <= end) & ~torch.isnan(vals)
            for ts, vals, live in blocks]
    k = torch.cat([m.sum(1) for m in keep]
                  + [torch.zeros(0, dtype=torch.int64, device=device)])
    counts = torch.zeros(n_rows, dtype=torch.int64,
                         device=device).index_add_(0, row, k)
    # where each block's samples start in its row
    before = torch.empty_like(k)
    before[order] = torch.cumsum(k[order], 0) - k[order]
    at = before - (torch.cumsum(counts, 0) - counts)[row]
    S = max(int(counts.max()) if n_rows else 0, 1)
    ts_out = torch.full((n_rows, S), TS_PAD, dtype=torch.int32,
                        device=device)
    vals_out = torch.full((n_rows, S), float("nan"), dtype=torch.float64,
                          device=device)
    a = 0
    for (ts, vals, _), m in zip(blocks, keep):
        C = ts.shape[0]
        pos = at[a:a + C, None] + torch.cumsum(m, 1) - 1
        flat = (row[a:a + C, None] * S + pos)[m]
        ts_out.view(-1)[flat] = (ts[m] - start).to(torch.int32)
        vals_out.view(-1)[flat] = vals[m]
        a += C
    counts = counts.to(torch.int32).cpu().numpy()
    seconds["layout"] = time.perf_counter() - t
    return ts_out, vals_out, counts, seconds
