"""Sharded query programs over a (shard, time) mesh of ranks.

Port of ``filodb_tpu/parallel/dist_query.py``: a counter-corrected,
extrapolated Prometheus ``rate`` (and every function of ``COUNTER_FNS``
and ``_SIMPLE_COMBINE``) over series sharded across the ``shard`` axis
and samples sharded across the ``time`` axis, label groups reduced by a
segment sum and a sum over ``shard``. Each rank evaluates window partials
for its time block; the per-step summaries (count, first/last sample,
the block's counter-corrected increase, [P_l, K, 7]) are all-gathered
over ``time`` and combined in block order, counter resets that straddle
block boundaries included.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with dims
``("shard", "time")`` over the default process group
(``parallel/multiproc.init_distributed``: NCCL on cards, gloo on the
CPU), one rank a device; ``make_query_mesh`` builds it in the reference's
layout. The reference's collectives map one to one:

- ``lax.all_gather(parts, "time")``: ``all_gather_into_tensor`` over
  ``mesh.get_group("time")``;
- ``psum`` / ``pmin`` / ``pmax`` over ``"shard"``: ``all_reduce`` (SUM,
  MIN, MAX) of float tensors over ``mesh.get_group("shard")``;
- the ring's ``lax.ppermute``: paired ``isend`` / ``irecv`` along the time
  axis; the first block receives nothing and is masked as the reference
  masks the zeros it receives.

Calling convention: every ``make_*`` returns a function that EVERY rank of
the mesh calls, in the same order, on its own block: ``ts`` [P_l, S_l]
int32 relative ms (``TS_PAD`` past the last sample), ``vals`` [P_l, S_l],
``valid`` [P_l, S_l] bool (a prefix of each row: ``pad_for_mesh``),
``group_ids`` [P_l], and the replicated ``steps`` [K] int32 and
``window`` (int ms). ``shard_batch_arrays`` cuts a rank's block out of
the global host arrays by its mesh coordinates and puts it on the rank's
device. An aggregating program returns [G, K] on every rank; ``agg=None``
and the split pipeline's evaluations return this rank's [P_l, K] rows.

The second calling convention, a single controller: over a
``LocalMesh`` (a (shard, time) array of ``torch.device``s in one process,
where a device may fill several slots) the same programs are called ONCE,
with each block argument a list of one tensor a slot, in row-major order
over (shard, time), each on its slot's device (``shard_batch_arrays``
over a ``LocalMesh`` returns such lists); ``steps`` and ``window`` stay
single. The math is the same code: each per-block step runs on every
slot's block where it lies, and only the collectives differ. The gather
over ``time`` stacks a shard row's blocks in time order on the row's
first slot, and what follows it holds one tensor a shard row; the ring
passes each row's states from slot to slot; the reduction over ``shard``
folds the rows' partials in row order on the root slot (the first), so a
layout always gives one answer. An aggregating program returns its
[G, K] on the root slot; ``agg=None`` and the split pipeline's
evaluations return a list of each shard row's [P_l, K] rows.

Arithmetic runs in ``dtype`` (the port's float64 ``EXACT_DTYPE`` by
default, the reference's ``fdtype()`` under x64) in the reference's
order, so a 1×1 mesh answers what ``kernels.range_eval`` plus
``aggregations.aggregate`` answer. Segment sums add each group's rows in
row order (a stable sort, then ``segment_reduce``), as the reference's
``segment_sum`` does, and deterministically on the card. These programs
are plain PyTorch ops and collectives, as the reference's are jnp outside
any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from filodb_tpu_torch.device import EXACT_DTYPE
from filodb_tpu_torch.query.engine.kernels import _div

TS_PAD = np.iinfo(np.int32).max
_T_FIRST_NONE = 2**31 - 1
_T_LAST_NONE = -(2**31 - 1)
# elements of one row block's [rows, K, S] window mask (window min/max)
_MINMAX_BLOCK = 1 << 24


# ---------------------------------------------------------------------------
# the mesh

def make_query_mesh(n_devices: int | None = None,
                    time_axis: int | None = None):
    """The (shard × time) mesh over the process group's ranks, one rank a
    device: ``time_axis`` ranks on the sample axis (default 2 where the
    rank count is even, else 1), the rest on the series axis."""
    from torch.distributed.device_mesh import DeviceMesh

    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh spans the process group: {n_devices} "
                         f"devices asked, {n} ranks")
    if time_axis is None:
        time_axis = 2 if n % 2 == 0 and n >= 2 else 1
    if n % time_axis:
        raise ValueError(f"{n} ranks do not split into time axis "
                         f"{time_axis}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type,
                      torch.arange(n).reshape(n // time_axis, time_axis),
                      mesh_dim_names=("shard", "time"))


class LocalMesh:
    """A (shard, time) array of ``torch.device``s that one process drives
    (the single controller of the module's second calling convention). A
    device may fill several slots: every slot's block is launched and
    combined on its own all the same. ``devices`` is a nested list, one
    list a shard row."""

    def __init__(self, devices):
        rows = [[torch.device(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("a LocalMesh is a non-empty (shard, time) "
                             "array of devices")
        self.devices = rows

    def size(self, dim: int) -> int:
        return len(self.devices) if dim == 0 else len(self.devices[0])

    @property
    def shape(self) -> tuple[int, int]:
        return self.size(0), self.size(1)

    @property
    def slots(self) -> list:
        """Every slot's device, row-major over (shard, time)."""
        return [d for row in self.devices for d in row]

    @property
    def root(self) -> torch.device:
        """The first slot's device: where reductions over ``shard`` land."""
        return self.devices[0][0]

    def __len__(self) -> int:
        return self.size(0) * self.size(1)

    def __repr__(self) -> str:
        return (f"LocalMesh({self.size(0)}x{self.size(1)}: "
                f"{[str(d) for d in self.slots]})")


def mesh_axes(mesh) -> tuple[int, int]:
    """(shard, time) sizes of a ``DeviceMesh`` or a ``LocalMesh``, or of a
    ``(shard, time)`` pair."""
    if isinstance(mesh, tuple):
        return mesh
    return mesh.size(0), mesh.size(1)


def _coords(mesh) -> tuple[int, int]:
    s, t = mesh.get_coordinate()
    return int(s), int(t)


def _each(fn, *blocks):
    """``fn`` on each block: list arguments (a ``LocalMesh``'s blocks) go
    element by element, the rest whole; a rank's own tensors go at once."""
    lists = [b for b in blocks if isinstance(b, list)]
    if not lists:
        return fn(*blocks)
    return [fn(*(b[i] if isinstance(b, list) else b for b in blocks))
            for i in range(len(lists[0]))]


def _unzipped(out):
    """A ``LocalMesh``'s list of per-block tuples → a tuple of per-block
    lists; a rank's own tuple as it is."""
    return tuple(list(x) for x in zip(*out)) if isinstance(out, list) \
        else out


def _per_row(mesh, blocks):
    """A ``LocalMesh``'s per-slot blocks → the first of each shard row
    (what the shard's time blocks share, its group ids); else as given."""
    if isinstance(blocks, list) and len(blocks) == len(mesh) \
            and mesh.size(1) > 1:
        return blocks[::mesh.size(1)]
    return blocks


def _all_gather_time(mesh, parts):
    """[dt, *parts.shape]: every time block's ``parts``, in block order.
    Over a ``LocalMesh``: a list of one such stack a shard row, on the
    row's first slot."""
    dt = mesh.size(1)
    if isinstance(mesh, LocalMesh):
        rows = [parts[s * dt:(s + 1) * dt] for s in range(mesh.size(0))]
        return [torch.stack([p.to(row[0].device) for p in row])
                for row in rows]
    # blocks concatenated along the first axis (the form gloo and NCCL
    # both take), then viewed as [dt, ...]
    out = torch.empty((dt * parts.shape[0], *parts.shape[1:]),
                      dtype=parts.dtype, device=parts.device)
    dist.all_gather_into_tensor(out, parts.contiguous(),
                                group=mesh.get_group("time"))
    return out.view(dt, *parts.shape)


_FOLD = {dist.ReduceOp.SUM: torch.add, dist.ReduceOp.MIN: torch.minimum,
         dist.ReduceOp.MAX: torch.maximum}


def _reduce_shard(mesh, x, op):
    """``op`` over the shard axis. Over a ``LocalMesh`` ``x`` holds one
    tensor a shard row; they are folded in row order on the root slot."""
    if isinstance(mesh, LocalMesh):
        acc = x[0].to(mesh.root)
        for part in x[1:]:
            acc = _FOLD[op](acc, part.to(mesh.root))
        return acc
    dist.all_reduce(x, op=op, group=mesh.get_group("shard"))
    return x


# ---------------------------------------------------------------------------
# per-block partials

def _window_bounds(ts, steps, window):
    """[lo, hi) sample bounds of (t - w, t] per series and step."""
    P = ts.shape[0]
    t = steps.to(device=ts.device, dtype=ts.dtype)[None, :].expand(
        P, -1).contiguous()
    ts = ts.contiguous()
    hi = torch.searchsorted(ts, t, right=True)
    lo = torch.searchsorted(ts, t - window, right=True)
    return lo, hi


def _counter_correct(v, valid):
    """Block-local counter-reset correction (monotonized values): the
    cumulative sum of every dropped previous value added back, as
    ``kernels.range_eval``. ``v`` must already be masked (invalid
    positions zeroed)."""
    prev = torch.cat([v[:, :1], v[:, :-1]], 1)
    both = valid & torch.cat([torch.zeros_like(valid[:, :1]),
                              valid[:, :-1]], 1)
    dropped = (v < prev) & both
    del both
    corr = prev.masked_fill_(~dropped, 0.0).cumsum_(1)
    return corr.add_(v)  # v + corr


def _g(x, idx):
    return torch.gather(x, 1, idx)


def _rate_partials_from_bounds(ts, vals, counts_mask, lo, hi, cv=None,
                               raw=None, dtype=EXACT_DTYPE):
    """[P_l, K, 7] rate partials given window bounds: n, t_first, v_first,
    t_last, v_last, the internal (counter-corrected when ``cv`` is given)
    increase, v_first_raw. Shared by the fused programs and the split
    pipeline, so both run the same float ops."""
    valid = counts_mask
    v = torch.where(valid, vals, 0.0).to(dtype)
    if cv is None:
        cv = v
    n = (hi - lo).to(torch.int32)
    has = hi > lo
    i_first = lo.clamp(max=ts.shape[1] - 1).long()
    i_last = (hi - 1).clamp(min=0).long()
    t_first = torch.where(has, _g(ts, i_first), _T_FIRST_NONE).to(dtype)
    t_last = torch.where(has, _g(ts, i_last), _T_LAST_NONE).to(dtype)
    v_first = torch.where(has, _g(v, i_first), 0.0)
    v_last = torch.where(has, _g(v, i_last), 0.0)
    inc = torch.where(has, _g(cv, i_last) - _g(cv, i_first), 0.0)
    if raw is None:
        v_first_raw = v_first
    else:
        rawm = torch.where(valid, raw, 0.0).to(dtype)
        v_first_raw = torch.where(has, _g(rawm, i_first), 0.0)
    return torch.stack([n.to(dtype), t_first, v_first, t_last, v_last, inc,
                        v_first_raw], -1)


def _local_rate_partials(ts, vals, counts_mask, steps, window,
                         counter: bool = True, raw=None, dtype=EXACT_DTYPE):
    """Window partials of this rank's (P_l, S_l) block, [P_l, K, 7]
    (missing: n = 0 and sentinels). ``raw`` [P_l, S_l], the uncorrected
    values of a pre-corrected lane, feeds only ``v_first_raw``."""
    lo, hi = _window_bounds(ts, steps, window)
    cv = None
    if counter:
        cv = _counter_correct(torch.where(counts_mask, vals, 0.0).to(dtype),
                              counts_mask)
    return _rate_partials_from_bounds(ts, vals, counts_mask, lo, hi, cv=cv,
                                      raw=raw, dtype=dtype)


def _combine_time_partials(parts, steps, window, mode: str = "rate",
                           counter: bool = True):
    """All-gathered time-block partials [dt, P, K, 7] → [P, K]: a combine
    over the blocks in order, counter resets across block boundaries
    included, then Prometheus' extrapolation from the global first/last
    samples. ``mode``: "rate", "increase" (extrapolated, not divided by
    the window) or "delta" (non-counter increase, extrapolated)."""
    dtt = parts.dtype
    dev = parts.device
    n_tot = parts[..., 0].sum(0)
    t_first_g = parts[..., 1].amin(0)
    t_last_g = parts[..., 3].amax(0)

    total_inc = torch.zeros_like(parts[0, ..., 5])
    has_prev = torch.zeros(parts.shape[1:3], dtype=torch.bool, device=dev)
    v_prev = torch.zeros_like(total_inc)
    v_first_g = torch.zeros_like(total_inc)
    for d in range(parts.shape[0]):
        nd = parts[d, ..., 0] > 0
        vf, vl, inc = parts[d, ..., 2], parts[d, ..., 4], parts[d, ..., 5]
        if counter:
            boundary = torch.where(
                nd & has_prev,
                torch.where(vf < v_prev, vf, vf - v_prev), 0.0)
        else:
            boundary = torch.where(nd & has_prev, vf - v_prev, 0.0)
        total_inc = total_inc + inc + boundary
        # the global first's raw value (field 6), for extrapolate-to-zero
        v_first_g = torch.where(nd & ~has_prev, parts[d, ..., 6], v_first_g)
        v_prev = torch.where(nd, vl, v_prev)
        has_prev = has_prev | nd
    return _extrapolate(n_tot, t_first_g, t_last_g, total_inc, v_first_g,
                        steps, window, mode,
                        counter and mode != "delta", dtt, dev)


def _extrapolate(n_tot, t_first_g, t_last_g, total_inc, v_first_g, steps,
                 window, mode: str, to_zero: bool, dtt, dev):
    """Prometheus' extrapolatedRate over the combined partials, shared by
    the gather and ring forms. ``to_zero``: the extrapolate-to-zero
    heuristic, which Prometheus applies to rate and increase only.

    Durations are differenced in integer ms, then divided, as the port's
    ``kernels.range_eval`` and B3 take them (ROADMAP §C, "B3's time
    arithmetic"): the first/last times are whole ms, exact in float64, so
    a 1x1 mesh takes the same threshold branches as ``range_eval``. The
    reference divides each time by 1000 first; integer counters put many
    windows' ``dur_start`` exactly on the threshold, where the two orders
    round to other branches."""
    st = steps.to(device=dev, dtype=dtt)[None, :]
    sampled = _div(t_last_g - t_first_g, 1000.0)
    avg_dur = sampled / (n_tot - 1.0).clamp(min=1.0)
    dur_start = _div(t_first_g - (st - float(window)), 1000.0)
    dur_end = _div(st - t_last_g, 1000.0)
    if to_zero:
        inf = torch.tensor(float("inf"), dtype=dtt, device=dev)
        dur_to_zero = torch.where(
            total_inc > 0,
            sampled * v_first_g / total_inc.clamp(min=1e-30), inf)
        dur_start = torch.minimum(dur_start, dur_to_zero)
    threshold = avg_dur * 1.1
    extend = sampled
    extend = extend + torch.where(dur_start < threshold, dur_start,
                                  _div(avg_dur, 2.0))
    extend = extend + torch.where(dur_end < threshold, dur_end,
                                  _div(avg_dur, 2.0))
    ext = total_inc * extend / sampled.clamp(min=1e-10)
    if mode == "rate":
        out = ext / _div(torch.tensor(float(window), dtype=dtt, device=dev),
                         1000.0)
    else:  # increase / delta
        out = ext
    nan = torch.tensor(float("nan"), dtype=dtt, device=dev)
    return torch.where(n_tot >= 2, out, nan)


def _eprefix(x):
    return torch.cat([torch.zeros_like(x[:, :1]), torch.cumsum(x, 1)], 1)


def _simple_prefixes(vals, counts_mask, dtype=EXACT_DTYPE):
    """Exclusive prefix sums (value, count, value²) [P_l, S_l + 1]: the
    per-batch state that makes every window sum a pair of gathers."""
    valid = counts_mask
    v = torch.where(valid, vals, 0.0).to(dtype)
    return _eprefix(v), _eprefix(valid.to(dtype)), _eprefix(v * v)


def _window_minmax(vals, valid, lo, hi):
    """Masked window min and max [P_l, K] (+inf / -inf where a window
    holds no valid sample), row block by row block so the [rows, K, S]
    mask stays bounded."""
    P, S = vals.shape
    K = lo.shape[1]
    rows = max(1, _MINMAX_BLOCK // max(K * S, 1))
    sidx = torch.arange(S, device=vals.device)[None, None, :]
    mns, mxs = [], []
    for a in range(0, P, rows):
        b = min(a + rows, P)
        in_win = (sidx >= lo[a:b, :, None]) & (sidx < hi[a:b, :, None]) \
            & valid[a:b, None, :]
        x = vals[a:b, None, :]
        mns.append(torch.where(in_win, x, float("inf")).amin(2))
        mxs.append(torch.where(in_win, x, float("-inf")).amax(2))
    if not mns:
        empty = torch.empty((0, K), dtype=vals.dtype, device=vals.device)
        return empty, empty
    return torch.cat(mns), torch.cat(mxs)


def _simple_partials_from_bounds(ts, vals, counts_mask, csum, cnt, csum2,
                                 lo, hi, with_minmax: bool = True,
                                 dtype=EXACT_DTYPE):
    """[P_l, K, 7] simple-function partials given prefixes and bounds: sum,
    count, min, max, last, t_last, sumsq. ``with_minmax=False`` fills the
    min/max fields with sentinels (window min/max have no prefix form)."""
    valid = counts_mask
    v = torch.where(valid, vals, 0.0).to(dtype)
    lo, hi = lo.long(), hi.long()
    s = _g(csum, hi) - _g(csum, lo)
    s2 = _g(csum2, hi) - _g(csum2, lo)
    n = _g(cnt, hi) - _g(cnt, lo)
    if with_minmax:
        mn, mx = _window_minmax(vals.to(dtype), valid, lo, hi)
    else:
        mn = torch.full_like(s, float("inf"))
        mx = torch.full_like(s, float("-inf"))
    has = n > 0
    i_last = (hi - 1).clamp(min=0)
    last = torch.where(has, _g(v, i_last), 0.0)
    t_last = torch.where(has, _g(ts, i_last), _T_LAST_NONE).to(dtype)
    return torch.stack([s, n, mn, mx, last, t_last, s2], -1)


def _local_simple_partials(ts, vals, counts_mask, steps, window,
                           with_minmax: bool = True, dtype=EXACT_DTYPE):
    """Partials of the associative over-time functions, [P_l, K, 7] = sum,
    count, min, max, last, t_last, sumsq (+inf / -inf / 0 sentinels)."""
    lo, hi = _window_bounds(ts, steps, window)
    csum, cnt, csum2 = _simple_prefixes(vals, counts_mask, dtype)
    return _simple_partials_from_bounds(ts, vals, counts_mask, csum, cnt,
                                        csum2, lo, hi, with_minmax, dtype)


def _sc_var(p):
    n = p[..., 1].sum(0)
    s = p[..., 0].sum(0)
    s2 = p[..., 6].sum(0)
    mean = s / n.clamp(min=1.0)
    return n, (s2 / n.clamp(min=1.0) - mean * mean).clamp(min=0.0)


def _nan_like(x):
    return torch.tensor(float("nan"), dtype=x.dtype, device=x.device)


def _last(p):
    at = torch.argmax(p[..., 5], 0)[None]
    return torch.gather(p[..., 4], 0, at)[0]


def _stdvar(p):
    n, var = _sc_var(p)
    return torch.where(n > 0, var, _nan_like(var))


def _stddev(p):
    n, var = _sc_var(p)
    return torch.where(n > 0, torch.sqrt(var), _nan_like(var))


def _present(p, out):
    return torch.where(p[..., 1].sum(0) > 0, out, _nan_like(p))


_SIMPLE_COMBINE = {
    "sum_over_time": lambda p: _present(p, p[..., 0].sum(0)),
    "count_over_time": lambda p: _present(p, p[..., 1].sum(0)),
    "avg_over_time": lambda p: _present(
        p, p[..., 0].sum(0) / p[..., 1].sum(0).clamp(min=1.0)),
    "min_over_time": lambda p: _present(p, p[..., 2].amin(0)),
    "max_over_time": lambda p: _present(p, p[..., 3].amax(0)),
    "last_over_time": lambda p: _present(p, _last(p)),
    "last_sample": lambda p: _present(p, _last(p)),
    "present_over_time": lambda p: _present(
        p, torch.ones_like(p[0, ..., 0])),
    "stdvar_over_time": _stdvar,
    "stddev_over_time": _stddev,
}
# the simple functions whose combine reads the min / max fields
_MINMAX_FNS = ("min_over_time", "max_over_time")


# ---------------------------------------------------------------------------
# the group reduce

def _segment_sum(x, gid, num_groups: int):
    """[G, K] per-group sums of ``x`` [P, K], each group's rows added in
    row order (the reference's ``segment_sum`` order), deterministic on
    the card: a stable sort by group, then ``segment_reduce``."""
    order = torch.sort(gid, stable=True).indices
    lengths = torch.zeros(num_groups, dtype=torch.int64,
                          device=x.device).index_add_(
        0, gid, torch.ones_like(gid))
    return torch.segment_reduce(x[order], "sum", lengths=lengths, axis=0,
                                unsafe=True)


def _segment_extreme(res, gid, num_groups: int, agg: str):
    """[G, K] per-group min (max) of the present values of ``res``; the
    sentinel where a group has none."""
    sentinel = float("inf") if agg == "min" else float("-inf")
    marked = torch.where(~torch.isnan(res), res, sentinel)
    seg = torch.full((num_groups, res.shape[1]), sentinel, dtype=res.dtype,
                     device=res.device)
    return seg.scatter_reduce_(0, gid[:, None].expand_as(marked), marked,
                               reduce="amin" if agg == "min" else "amax")


def _group_reduce(res, gid_l, num_groups: int, agg: str, mesh):
    """[P_l, K] per-series results → [G, K] grouped aggregate (the
    segment reduce, then SUM / MIN / MAX over the shard axis). NaN = series
    absent at that step. Over a ``LocalMesh`` ``res`` holds a shard row's
    rows a row (``gid_l`` a row's or a slot's ids) and the answer lands on
    the root slot."""
    gid = _each(lambda r, g: g.to(device=r.device, dtype=torch.int64), res,
                _per_row(mesh, gid_l))
    contrib = _each(lambda r: torch.where(~torch.isnan(r), r, 0.0), res)
    gcnt = _reduce_shard(mesh, _each(
        lambda r, g: _segment_sum((~torch.isnan(r)).to(r.dtype), g,
                                  num_groups), res, gid), dist.ReduceOp.SUM)
    nan = _nan_like(gcnt)
    if agg in ("min", "max"):
        seg = _reduce_shard(mesh, _each(
            lambda r, g: _segment_extreme(r, g, num_groups, agg), res, gid),
            dist.ReduceOp.MIN if agg == "min" else dist.ReduceOp.MAX)
        return torch.where(gcnt > 0, seg, nan)
    gsum = _reduce_shard(mesh, _each(
        lambda c, g: _segment_sum(c, g, num_groups), contrib, gid),
        dist.ReduceOp.SUM)
    if agg in ("stddev", "stdvar"):
        gsum2 = _reduce_shard(mesh, _each(
            lambda c, g: _segment_sum(c * c, g, num_groups), contrib, gid),
            dist.ReduceOp.SUM)
        mean = gsum / gcnt.clamp(min=1.0)
        var = (gsum2 / gcnt.clamp(min=1.0) - mean * mean).clamp(min=0.0)
        out = var if agg == "stdvar" else torch.sqrt(var)
        return torch.where(gcnt > 0, out, nan)
    if agg == "avg":
        return torch.where(gcnt > 0, gsum / gcnt.clamp(min=1.0), nan)
    if agg == "count":
        return torch.where(gcnt > 0, gcnt, nan)
    if agg == "group":
        return torch.where(gcnt > 0, torch.ones_like(gcnt), nan)
    return torch.where(gcnt > 0, gsum, nan)


COUNTER_FNS = {"rate": ("rate", True), "increase": ("increase", True),
               "delta": ("delta", False)}

# aggs with associative mesh reductions
MESH_AGG_OPS = ("sum", "avg", "count", "min", "max", "stddev", "stdvar",
                "group")


def make_distributed_range_agg(mesh, fn: str, num_groups: int,
                               agg: str | None = "sum",
                               dtype: torch.dtype = EXACT_DTYPE):
    """``agg(fn(x[w])) by (g)`` over the (shard, time) mesh: time-block
    partials all-gathered over ``time``, label groups reduced by segment
    ops and collectives over ``shard``. ``agg=None`` returns this rank's
    per-series rows [P_l, K]."""

    def per_series(ts_l, vals_l, valid_l, steps, window, raw_l=None):
        if fn in COUNTER_FNS:
            mode, counter = COUNTER_FNS[fn]
            parts = _each(lambda t, v, ok, r: _local_rate_partials(
                t, v, ok, steps, window, counter=counter, raw=r,
                dtype=dtype), ts_l, vals_l, valid_l, raw_l)
            gathered = _all_gather_time(mesh, parts)  # [dt, P_l, K, 7]
            return _each(lambda g: _combine_time_partials(
                g, steps, window, mode=mode, counter=counter), gathered)
        combine = _SIMPLE_COMBINE[fn]
        parts = _each(lambda t, v, ok: _local_simple_partials(
            t, v, ok, steps, window, fn in _MINMAX_FNS, dtype),
            ts_l, vals_l, valid_l)
        return _each(combine, _all_gather_time(mesh, parts))

    def step(ts, vals, valid, group_ids, steps, window, raw=None):
        res = per_series(ts, vals, valid, steps, window, raw)
        if agg is None:
            return res
        return _group_reduce(res, group_ids, num_groups, agg, mesh)

    return step


# ---- split pipeline: prepare / bounds / eval / group reduce ---------------
#
# The fused programs recompute two batch-level passes on every query: the
# counter-correction cumsum over [P, S] and the window bounds. The split
# pipeline hoists both into programs of their own whose outputs stay on
# the device, so a warm query runs only the evaluation's gathers, the
# time-axis gather of [dt, P_l, K, 7] partials and the group reduce. All
# reuse the fused programs' helpers, so the answers are the same bits.
# Window min/max have no prefix form and stay on the fused program.
SPLIT_FNS = ("rate", "increase", "delta", "sum_over_time",
             "count_over_time", "avg_over_time", "last_over_time",
             "present_over_time", "stddev_over_time", "stdvar_over_time")
_SIMPLE_SPLIT_FNS = tuple(f for f in SPLIT_FNS if f not in COUNTER_FNS)


def make_mesh_prepare(mesh, kind: str, dtype: torch.dtype = EXACT_DTYPE):
    """The per-batch-version prepare program. ``kind="counter"``: (vals,
    valid) → counter-corrected values [P_l, S_l] (block-local; resets
    across blocks are the combine's boundary terms). ``kind="prefix"``:
    (vals, valid) → (csum, cnt, csum2), each block's exclusive prefixes
    [P_l, S_l + 1]."""

    def one(vals, valid):
        if kind == "counter":
            return _counter_correct(torch.where(valid, vals, 0.0).to(dtype),
                                    valid)
        return _simple_prefixes(vals, valid, dtype)

    def prep(vals, valid):
        out = _each(one, vals, valid)
        return _unzipped(out) if kind == "prefix" else out

    return prep


def make_mesh_bounds(mesh):
    """The window-bounds program: (ts, steps, window) → (lo, hi) int32
    [P_l, K], local to this rank's time block."""

    def one(ts, steps, window):
        lo, hi = _window_bounds(ts, steps, window)
        return lo.to(torch.int32), hi.to(torch.int32)

    def bounds(ts, steps, window):
        return _unzipped(_each(one, ts, steps, window))

    return bounds


def make_mesh_eval_delta(mesh, fn: str, counter: bool | None = None,
                         dtype: torch.dtype = EXACT_DTYPE):
    """rate / increase / delta from cached correction and bounds: gathers →
    [P_l, K, 7] partials → gathered over ``time`` → the combine. Returns
    this rank's rows [P_l, K]. ``counter`` overrides the function's
    default (delta over a counter schema is reset-corrected)."""
    mode, default_counter = COUNTER_FNS[fn]
    counter = default_counter if counter is None else counter

    def ev(ts, vals, valid, lo, hi, steps, window, cv=None, raw=None):
        parts = _each(lambda t, v, ok, a, b, c, r: _rate_partials_from_bounds(
            t, v, ok, a, b, cv=c, raw=r, dtype=dtype),
            ts, vals, valid, lo, hi, cv, raw)
        return _each(lambda g: _combine_time_partials(
            g, steps, window, mode=mode, counter=counter),
            _all_gather_time(mesh, parts))

    return ev


def make_mesh_eval_simple(mesh, fn: str, dtype: torch.dtype = EXACT_DTYPE):
    """The prefix-summable over-time functions from cached prefixes and
    bounds; this rank's rows [P_l, K]."""
    if fn not in _SIMPLE_SPLIT_FNS:
        raise ValueError(f"{fn} has no split (prefix) form")
    combine = _SIMPLE_COMBINE[fn]

    def ev(ts, vals, valid, csum, cnt, csum2, lo, hi, steps, window):
        parts = _each(lambda *b: _simple_partials_from_bounds(
            *b, with_minmax=False, dtype=dtype),
            ts, vals, valid, csum, cnt, csum2, lo, hi)
        return _each(combine, _all_gather_time(mesh, parts))

    return ev


def make_mesh_group_reduce(mesh, num_groups: int, agg: str):
    """The per-query step of the split pipeline: this rank's cached rows
    [P_l, K] → [G, K], one segment reduce and one reduction over
    ``shard``."""

    def step(series_vals, group_ids):
        return _group_reduce(series_vals, group_ids, num_groups, agg, mesh)

    return step


def make_distributed_sum_rate(mesh, num_groups: int,
                              dtype: torch.dtype = EXACT_DTYPE):
    """The distributed ``sum(rate(x[w])) by (g)``: [G, K] group sums on
    every rank."""

    def step(ts, vals, valid, group_ids, steps, window, raw=None):
        parts = _each(lambda t, v, ok, r: _local_rate_partials(
            t, v, ok, steps, window, raw=r, dtype=dtype),
            ts, vals, valid, raw)
        rate = _each(lambda g: _combine_time_partials(g, steps, window),
                     _all_gather_time(mesh, parts))
        return _group_reduce(rate, group_ids, num_groups, "sum", mesh)

    return step


def shard_batch_arrays(mesh, ts, vals, valid, group_ids, raw=None,
                       device=None):
    """This rank's block of the global host arrays (its mesh coordinates'
    rows of ``ts``, ``vals``, ``valid`` and ``raw`` [P, S], and of
    ``group_ids`` [P]), on ``device`` (the mesh's: the current card under
    NCCL, else the CPU). P and S must divide by the mesh (``pad_for_mesh``).
    Over a ``LocalMesh``: each array as a list of every slot's block on
    the slot's device, row-major over (shard, time)."""
    ds, dt = mesh_axes(mesh)
    P, S = ts.shape
    if P % ds or S % dt:
        raise ValueError(f"[{P}, {S}] does not divide over a {ds}×{dt} "
                         f"mesh: pad it (pad_for_mesh)")
    pl, sl = P // ds, S // dt

    def block(s_idx, t_idx, dev):
        rows = slice(s_idx * pl, (s_idx + 1) * pl)
        cols = slice(t_idx * sl, (t_idx + 1) * sl)

        def put(x, *idx):
            return torch.as_tensor(np.ascontiguousarray(x[idx])).to(dev)

        placed = (put(ts, rows, cols), put(vals, rows, cols),
                  put(valid, rows, cols), put(group_ids, rows))
        if raw is not None:
            placed += (put(raw, rows, cols),)
        return placed

    if isinstance(mesh, LocalMesh):
        return _unzipped([block(s, t, mesh.devices[s][t])
                          for s in range(ds) for t in range(dt)])
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if mesh.device_type == "cuda" else torch.device("cpu")
    return block(*_coords(mesh), device)


def pad_for_mesh(ts, vals, counts, group_ids, mesh):
    """P padded to a multiple of the mesh's ``shard`` size and S to its
    ``time`` size (host arrays); returns the padded arrays and a validity
    mask (which replaces counts: they don't shard along the time axis).
    Padding series join group 0 and contribute nothing."""
    ds, dtm = mesh_axes(mesh)
    P_, S_ = ts.shape
    Pp = -(-P_ // ds) * ds
    Sp = -(-S_ // dtm) * dtm
    ts_p = np.full((Pp, Sp), TS_PAD, np.int32)
    vals_p = np.zeros((Pp, Sp), vals.dtype)
    valid = np.zeros((Pp, Sp), bool)
    ts_p[:P_, :S_] = ts
    vals_p[:P_, :S_] = np.nan_to_num(vals, nan=0.0)
    valid[:P_, :S_] = np.arange(S_)[None, :] < counts[:, None]
    gid_p = np.zeros(Pp, np.int32)
    gid_p[:P_] = group_ids
    return ts_p, vals_p, valid, gid_p


def _ring_state(parts):
    """A block's own ring state [P_l, K, 8] (n so far, t_first, v_first,
    increase so far, has_prev, v_prev, t_last, v_first_raw) from its rate
    partials [P_l, K, 7]."""
    n_l, tf_l, vf_l, tl_l, vl_l, inc_l, vfr_l = [
        parts[..., i] for i in range(7)]
    has_l = n_l > 0
    zero = torch.zeros_like(n_l)
    return torch.stack([
        n_l, tf_l, torch.where(has_l, vf_l, zero), inc_l,
        has_l.to(parts.dtype), torch.where(has_l, vl_l, zero), tl_l,
        torch.where(has_l, vfr_l, zero)], -1)


def _ring_combine(prev, parts, first_block: bool):
    """One hop of the ring: the state received from the previous time
    block combined with this block's partials [P_l, K, 7]."""
    n_l, tf_l, vf_l, tl_l, vl_l, inc_l, vfr_l = [
        parts[..., i] for i in range(7)]
    has_l = n_l > 0
    zero = torch.zeros_like(n_l)
    # the first block receives nothing (zeros): mask the counts and flags
    # and re-sentinel the min/max-combined fields, so zeros cannot pollute
    # t_first (min) / t_last (max)
    p_n, p_tf, p_vf, p_inc, p_has, p_vl, p_tl, p_vfr = [
        prev[..., i] for i in range(8)]
    if first_block:
        p_n = torch.zeros_like(p_n)
        p_has = torch.zeros_like(p_has)
        p_inc = torch.zeros_like(p_inc)
        p_vfr = torch.zeros_like(p_vfr)
    no_prev = p_has == 0
    p_tf = torch.where(no_prev, float(_T_FIRST_NONE), p_tf)
    p_tl = torch.where(no_prev, float(_T_LAST_NONE), p_tl)
    boundary = torch.where(has_l & (p_has > 0),
                           torch.where(vf_l < p_vl, vf_l, vf_l - p_vl), zero)
    n_c = p_n + n_l
    inc_c = p_inc + inc_l + boundary
    tf_c = torch.minimum(p_tf, tf_l)
    vf_c = torch.where(p_has > 0, p_vf, torch.where(has_l, vf_l, zero))
    vfr_c = torch.where(p_has > 0, p_vfr, torch.where(has_l, vfr_l, zero))
    has_c = torch.maximum(p_has, has_l.to(parts.dtype))
    vl_c = torch.where(has_l, vl_l, p_vl)
    tl_c = torch.maximum(p_tl, tl_l)
    return torch.stack([n_c, tf_c, vf_c, inc_c, has_c, vl_c, tl_c, vfr_c],
                       -1)


def make_distributed_sum_rate_ring(mesh, num_groups: int,
                                   dtype: torch.dtype = EXACT_DTYPE,
                                   agg: str | None = "sum"):
    """The ring form of ``make_distributed_sum_rate``: instead of
    all-gathering every time block's partials, the running combine state
    [P_l, K, 8] (``_ring_state``) passes from each time block to the next,
    dt - 1 hops of paired send / receive (over a ``LocalMesh``: a copy to
    the next slot's device). Memory per block stays O(P_l·K) whatever dt
    is. ``agg=None`` returns the per-series rates (``group_ids`` unread)."""

    ds_size, dt_size = mesh_axes(mesh)
    local = isinstance(mesh, LocalMesh)
    if local:
        firsts = [t == 0 for _ in range(ds_size) for t in range(dt_size)]
    else:
        s_idx, t_idx = _coords(mesh)
        ranks = mesh.mesh.tolist()
        # this block's neighbours along the time axis (global ranks)
        nxt = ranks[s_idx][t_idx + 1] if t_idx + 1 < dt_size else None
        prv = ranks[s_idx][t_idx - 1] if t_idx > 0 else None
        firsts = t_idx == 0

    def shift(state):
        """Each block's state to the next time block; what the first
        block of a row receives is zeros."""
        if local:
            return [torch.zeros_like(st) if t == 0
                    else state[i - 1].to(st.device)
                    for i, (st, t) in enumerate(
                        zip(state, [t for _ in range(ds_size)
                                    for t in range(dt_size)]))]
        prev = torch.zeros_like(state)
        ops = []
        if nxt is not None:
            ops.append(dist.P2POp(dist.isend, state.contiguous(), nxt))
        if prv is not None:
            ops.append(dist.P2POp(dist.irecv, prev, prv))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return prev

    def last_block(state):
        """The full combine, which the last time block holds, on every
        block of its row (a masked sum, one contributor); over a
        ``LocalMesh``, a row's last slot's state a row."""
        if local:
            return [state[(s + 1) * dt_size - 1] for s in range(ds_size)]
        if dt_size == 1:
            return state
        full = state if t_idx == dt_size - 1 else torch.zeros_like(state)
        dist.all_reduce(full, group=mesh.get_group("time"))
        return full

    def step(ts, vals, valid, group_ids, steps, window, raw=None):
        parts = _each(lambda t, v, ok, r: _local_rate_partials(
            t, v, ok, steps, window, raw=r, dtype=dtype),
            ts, vals, valid, raw)
        state = _each(_ring_state, parts)
        for _ in range(dt_size - 1):
            state = _each(_ring_combine, shift(state), parts, firsts)
        del parts

        def rate(full):
            (n_tot, t_first_g, _, total_inc, _, _, t_last_g,
             v_first_raw_g) = [full[..., i] for i in range(8)]
            return _extrapolate(n_tot, t_first_g, t_last_g, total_inc,
                                v_first_raw_g, steps, window, "rate", True,
                                dtype, full.device)

        rates = _each(rate, last_block(state))
        if agg is None:
            return rates
        return _group_reduce(rates, group_ids, num_groups, agg, mesh)

    return step
