#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``filodb_tpu_torch`` end to end at a real deployment's size and
checks it, phase by phase; any failed phase exits non-zero:

1. build the four CUDA kernels from ``filodb_tpu_torch/csrc`` (nvcc, sm_90a);
2. ingest ``--series`` prom-counter series of ``http_requests_total``
   (labels ``_ws_``, ``_ns_`` over 100 namespaces, ``instance``, ``job``),
   ``--samples`` samples each at 10 s with ±500 ms scrape jitter, counter
   increments 0-19 and a reset in about 5 % of series, into 4 shards,
   spread 1, 400-sample chunks (``conf/server.json``);
3. the main path: launch counts set to 0, then ``QueryService.query_range``
   over the whole 2 h at a 60 s step for four queries (cold once, then warm
   repeats), counts read back; every kernel must have launched (in the
   cold runs: a warm query answers from the mesh engine's window cache and
   launches no B3 or B4); then one warm round's launches, the four warm
   p50s again with ``FILODB_MESH_SPLIT=0`` (the window cache off, the path
   of the runs before it) with their launches, bit for bit the cached answers, and
   the cache's entries and device bytes (a ``{"main_path": ...}`` line).
   The smoke's queries carry a ``QueryContext`` that raises the default
   result-sample limit of 1,000,000 (``wide``: phase 3's ``increase``
   answers 121 M samples) and a deadline of ``SMOKE_TIMEOUT_S``;
4. every kernel against its plain PyTorch version on the card, at the
   shapes the main path gave it, with its time, its plain version's time,
   its bound and (for B4) a PyTorch yardstick; and the time of each part
   of one count_over_time decode chunk (B1, B2, ``assemble``'s glue, the
   pad select and cast, B4);
5. answers: the main results have the expected shape and finite values,
   agree with the plain path, and a small store answers the same on the
   card as on the CPU, for the four queries and one query of every other
   family the port serves (``FAMILY_QUERIES``);
6. long ranges: a second store of ``--long-series`` series with
   ``--long-samples`` samples each (48 h at 10 s, so NB = 256 blocks and
   S = 32,768 samples a series), queried over the 48 h at a 60 s step
   (K = 2,881) with ``sum(rate[5m]) by (_ns_)``, ``sum(count_over_time[5m])
   by (job)`` and ``increase[1h]``; B3 and B4 must launch, match their plain
   versions on the card, and the answers must agree with the plain path;
7. the rest of PromQL on the phase-2 store (not ingested again): launch
   counts set to 0, then ``PROMQL_QUERIES`` (instant selectors, min/max and
   stddev over time, topk, irate times a number, quantile_over_time, a
   one-to-one join) and ``MAPPED_QUERIES`` (aggregations over an operator
   or an instant function) cold once and warm three times, counts and peak
   device memory read back; B1/B2 and B3 must have launched; the answers'
   shapes, finiteness, the join against its two sides and each mapped
   query against its plain form are checked; max_over_time's and the
   instant selector's answers are held against plain decode plus the
   float64 function, with B1 and B2 bitwise against their plain versions
   on every chunk the engine cuts, and the join's two sides against B3's
   plain version; a warm time of every range function and the instant
   selector over one namespace (``PER_FUNCTION``); and the time of each
   part of one engine-sized decode chunk of max_over_time and of the
   instant selector (B1, B2, ``assemble``'s glue, the float64 function);
8. first-class histograms on a store of their own: ``--hist-series``
   ``prom-histogram`` series of ``http_req_latency`` (labels as phase 2's)
   with the 12 bucket bounds of Prometheus' ``DefBuckets`` and +Inf, 720
   samples at 10 s, per-scrape observations spread over the buckets and a
   reset of every bucket in about 5 % of series, and the series of
   App-0..App-9 again as ``le``-labelled prom-counter series on a second
   store; launch counts set to 0, then ``HIST_QUERIES`` (histogram_quantile
   over a per-bucket sum of rates, per series, a histogram matrix, over
   increase) and the flat form against its native twin, cold once and warm
   seven times (``HIST_WARM``: p50, min and max), counts and peak device
   memory read back; B1 and B3 must
   have launched; shapes, finite values and the ``le`` series of Prom JSON
   are checked, the flat answer must equal the native one (rtol 1e-5),
   and the first query must equal plain decode plus the float64 per-bucket
   rate, sum and quantile, with B1 bitwise against its plain version on
   the timestamp and bucket blocks of every chunk the engine cuts; a split
   of one engine-sized chunk (B1 on timestamps, B1 on buckets, the glue,
   the rate, the aggregation, the quantile), each part timed by CUDA
   events (median of 5 rounds) and by a ``torch.profiler`` trace's device
   time; and B1's time against its bound on a chunk's bucket blocks. The
   store also holds each histogram's ``sum`` and ``count`` columns, and
   ``HIST_EXEC_QUERIES`` (the mean latency ``sum(rate(h::sum[5m])) /
   sum(rate(h::count[5m]))`` by namespace, ``timestamp(h)`` and a join of
   two histogram rates) go through the default engine: the mesh engine
   must hand each to the exec engine, whose answer must equal the plain
   path on the card (B3's plain version over the sum and count pages; B1's
   plain version and the float64 function), cold once and warm five times;
   every query of phases 3, 7, 8 and 9 must have been served by the mesh
   engine, but phase 9's ``SIDECAR_INSTANT``: instant queries over
   functions the sidecar lane serves, which the service's mesh engine
   hands to exec, each with the lane forced and with it off (cold, warm
   p50, served and bypassed leaves, B1/B2 launches; the answers within
   rtol 2e-5, atol 1e-9) and once at the default gate;
10. (run after phase 5) the exec engine: ``QueryService(engine="exec")``,
   a leaf a shard, on the phase-2 store: ``EXEC_QUERIES`` (sum(rate) by
   namespace: B3 once a leaf; sum(count_over_time) by job: B1, B2 and B4
   in every leaf; a sum of rates whose shard key reads 2 of the 4 shards;
   a per-series rate) cold once and warm three times, each with its plan
   tree's leaf count and launches, against the mesh engine's answer in the
   same run (per series bit for bit, aggregated within rtol 1e-9) and its
   times, and the device memory both engines' batches hold;
11. (run after phase 9) durability: a store of the phase-2 generator's
   first ``--durable-series`` series (``DURABLE_SERIES``) on a local-disk
   column and meta store (sqlite) under a ``tempfile.mkdtemp()``
   directory, 20 flush groups a shard: flush it (chunks, codec bytes a
   sample, sqlite bytes, seconds); one more scrape of every series
   through record containers, routed by ``MemStore.shard_of`` into a
   ``SegmentedFileLog`` a shard and ingested at their offsets; half the
   groups flushed; ``chunk_infos`` of one series against the chunks
   written; the live answers of ``DURABLE_QUERIES`` on both engines over
   2 h plus the scrape; the store dropped; a new store on the directory
   and logs recovers its index, replays each log from its recovery start
   (keys, seconds, records, records below a watermark, records/s) and
   answers each query on each engine bitwise as the live store did, every
   chunk paged in from disk (cold split: store read, C++ decode, page
   encode, pack and upload; warm p50; chunks paged); the same for
   ``DURABLE_HIST_SERIES`` histograms through histogram containers and
   ``DURABLE_HIST``; B1-B4 must have launched in the phase. The directory
   has the standalone server's layout (``<dir>/columnstore`` and
   ``<dir>/wal/<dataset>/shard-<n>``);
12. (run after phase 11, over its directory) the node on the card:
   ``FiloServer`` (4 shards, spread 1, 400-sample chunks, 20 groups a
   shard, the mesh engine, HTTP and gateway on free ports) boots over
   phase 11's files (seconds to every shard ACTIVE, split into index
   recovery and replay); ``DURABLE_QUERIES`` through ``/api/v1/
   query_range``, cold and warm p50 of 5 beside ``QueryService``'s
   in-process p50, each body's data byte-equal to phase 11's live answer,
   one answer a kernel path against the plain versions; 8 client threads
   sending both queries 4 times each, every body byte-equal; one more
   scrape of every series as Influx lines over TCP into the gateway (lines
   a second, seconds until an instant ``count`` and ``sum`` at the scrape
   time see every series with the sum sent, and the latency of
   ``sum(rate)`` while the scrape is ingested); the flush scheduler at a
   0.5 s tick (snapshots every 10 s), its round robin from the first group
   without a checkpoint, until every group has one, every shard truncated
   its log below its smallest watermark and wrote its index snapshot;
   shutdown and
   boot 2 from the snapshot (index-restore seconds against boot 1's full
   scan), whose first query (App-0's instant sum at the scrape time)
   answers byte-equal to the live node's; B1-B4
   must have launched behind the HTTP API; the directory is removed and
   its bytes reported; and the control plane through HTTP: a request the
   governor sheds (capacity 1, a slot held) answers 503 with
   ``Retry-After``, one past a 1 ms deadline 503 ``timeout``, and
   ``debug/slow_queries`` and ``debug/costmodel`` answer;
13. (after phase 12) the shard's memory bound: a local-disk store of the
   phase-2 generator's first ``--evict-series`` series
   (``EVICT_SERIES``), a budget of ``EVICT_MEM_MB`` a shard and a
   retention of ``EVICT_RETENTION_MS``: flush, one more scrape of
   App-50..App-99, the answers of ``EVICT_QUERIES`` on both engines and
   an instant count, one scheduler tick (chunk bytes before and after,
   chunks evicted), ``evict_cold_partitions`` of the stopped half, the
   queries again (cold split, warm p50) bitwise as before with B1-B4
   launched on the paged-back shells, App-0's series scraped again (bloom
   queries, false positives, restored series, start times kept),
   ``purge_expired`` (exactly the stopped series not scraped again), the
   survivors' rows byte-equal to before and ``torch.cuda.memory_allocated``
   once the purged batches were replaced, and an index snapshot with the
   holes and the bloom restored into a new store whose first answer is
   byte-equal; its directory is removed;
14. (after phase 8) the host-decode lane: a store of phase 2's layout
   with ``--host-series`` series whose values float32 does not hold
   (``HOST_SHARES``: byte counters from 1e9-1e12, CPU seconds in
   hundredths, load averages with two decimals); the series that fail the
   float32 round trip; ``HOST_QUERIES`` over the 2 h at 60 s on the mesh
   and the exec engine, cold (split into the batch's build seconds:
   select and C++ decode on the host, upload, layout and
   correct-and-rebase on the card, and the rest)
   and warm p50 of ``HOST_WARM``; each must take the host-decode lane and
   its answer over the ``App-0``..``App-9`` namespaces must equal the
   port's own ``device="cpu"`` answer (rtol 2e-5, atol 1e-6); the instant
   ``HOST_INSTANT`` at the end (write buffers only) must be folded by the
   sidecar lane in float64, and an hour earlier (a sealed edge chunk, the
   fold forced) must bypass the lane to the host-decode lane, each equal
   to the CPU's; B3 must not launch; the batches' device bytes. Phase 3
   checks the other side of the gate: its ``sum(rate)`` over integer
   counters stays on B3;
15. (after phase 9) the serving front end, on a store of the phase-2
   generator's first ``--serving-series`` series (``SERVING_SERIES``):
   ``SERVING_BATCH`` range queries in flight through
   ``QueryService.query_range_many`` (the four phase-3 shapes in turn,
   member i's 2 h range slid by i mod 5 steps), cold and warm, against the
   same queries one at a time through ``query_range``, cold and warm:
   wall times and each kernel's launches in each run, every member equal
   to its single answer (rate and increase bit for bit, the others within
   rtol 2e-5, atol 1e-6); then ``SERVING_QUERY`` over the last 2 h
   through a service with the reference's default ``result_cache`` block:
   cold, ``SERVING_WARM`` warm repeats (extents hit and evaluated), two
   scrapes of a sample a series, each followed by the refresh one step
   later (only the head extent may be evaluated again) and the uncached
   query; every answer bit for bit the uncached service's; the batches'
   bytes on the card with the cache and without; B1-B4 must launch. Phase
   12's node boots with both caches at their defaults: its warm HTTP p50
   with the response cache on and off, its hits and misses, and the hot
   batch sizes of the 8 clients' passes with it off;
16. (after phase 15, on its store) the query control plane: the window
   cache under ingest (a scrape, then a miss on the new version, bit for
   bit a service with ``FILODB_MESH_SPLIT=0``); the governor
   (``CONTROL_THREADS`` threads of ``sum(rate) by (_ns_)`` against an
   admission capacity of 2, a queue of 2 and a wait of 0.5 s, the valve
   off: admitted, queued and shed counts and the admitted p50; a watchdog
   source forced to CRITICAL: the range query shed, the instant admitted,
   gateway records shed, then back to OK; a 1 ms ``query_timeout_s``
   raising ``DeadlineExceeded``; the samples budget on exec, partial with
   its warning and raising under ``"error"``; the default sample limit
   raising on a per-series ``increase``); the cost model's ``sidecar``
   site over ``SIDECAR_INSTANT`` at ``CONTROL_INSTANT_AT``, each repeated
   ``CONTROL_REPEATS`` times at the static arm, with the fold forced and
   then at the model's pick (decisions by source, the arm of every
   repeat, warm p50s), persisted and installed again through a local meta
   store with equal estimates; the adaptive engine (``query_range_many``
   batches of 1, 4 and 16 over App-0, ``ADAPTIVE_ROUNDS`` rounds: routed
   and shadowed counts by lane, the lanes' estimates, every answer equal
   to mesh's, the host lane's within rtol 2e-5, atol 1e-6); and one query
   traced at ``sample_rate`` 1, its span tree from the slow-query ring
   (threshold 1 ms).

17. (after phase 9, on a store of its own of the phase-2 generator's first
   ``CORE_SERIES`` series, which it changes; on the phase-2 store under
   ``--ingest-only``) the write path
   through the C++ ingest core (``core/memstore/native_shard.py``):
   ``CORE_SCRAPES`` scrapes of every series, 10 s apart from the 2 h's
   end, each shard's series in containers of ``CORE_CONTAINER`` records
   routed by ``MemStore.shard_of`` (the bytes made once and patched with
   numpy for each scrape), one ingest thread a shard: rows/s for the node
   and for each shard, and a scrape's seconds (p50, max); the key, the
   map's pid, the buffer rows and ``latest`` of ``CORE_CHECKED`` sampled
   series against what was sent; ``CORE_QUERY`` over the last 10 min on
   mesh (B3 must launch, held against its plain version and the plain
   path); phase 9's ``SIDECAR_INSTANT`` at the last scrape, whose windows
   hold write-buffer samples only (the lane's C++ fold), each against the
   decode lane, and where one warm lane instant spends its time (the
   write-buffer fold alone a shard, the host's largest self times, the
   device's largest kernels); then the seal wave (``Shard.seal`` of every
   series, one thread a shard): its seconds and chunks.
18. (after phase 14) long retention, on a local-disk store of its own
   under a ``tempfile.mkdtemp()`` directory: ``--longterm-series``
   counters of the phase-2 generator and a quarter as many load averages
   (phase 14's ``node_load1``, a ``gauge``, so ``ds-gauge`` is exercised),
   ``LT_SAMPLES`` samples at 10 s (6 h), flushed; the downsampler job's
   ``catch_up`` at 5 m and 1 h (seconds by step, raw rows/s, ds chunks and
   their bytes against the raw bytes), then a second one that must scan
   nothing; ``LT_QUERIES`` over the 6 h at 60 s (K = 361), ``now`` pinned
   to the data's end, a raw retention of 2 h and a memory one of 1 h,
   through ``LongTimeRangePlanner`` and ``TieredPlanner`` (cold, warm p50
   of ``LT_WARM``, ``QueryStats.tiers``, launches, the engine, which must
   be exec); B1-B4 must launch on downsampled or cold-tier data; each
   stitched answer must equal its tiers' own answers over their own step
   ranges and the other planner's, the ``App-0`` subset the port's
   ``device="cpu"`` answer (rtol 2e-5, atol 1e-6), and a warm repeat
   through the extent cache must page no cold or ds chunk in; then a
   ``FiloServer`` over the directory with ``downsample`` (``streaming``)
   and ``federation.mem_retention_ms``: ``/api/v1/status/tiers``, the
   first query through HTTP with ``?stats=all`` (its three tiers, equal
   to the in-process answer), and an hour more of App-0's counters
   flushed, the rollups published, a scheduler tick's ds flushes, and a
   ds query that sees them.
19. (after phase 18) the object-store tier, phase 18's generator and
   shapes (``--objectstore-series`` counters, a quarter as many load
   averages, 6 h at 10 s) flushed to a directory-backed ``FakeS3`` bucket
   with the reference's ``store`` defaults (flush and upload seconds,
   PUTs, bytes, segments, the upload queue's depth sampled every 10 ms),
   a restart that recovers every shard from the bucket (seconds, GETs,
   bytes), then over the restarted store a tiered planner (memory the last
   hour, the cold tier the rest) with the launch counts set to 0: a
   tiered ``sum(rate) by (_ns_)`` (B3 in both tiers), ``max_over_time``
   and ``avg_over_time`` over the cold tier through the pyramid lane (B1/B2
   on its edge chunks) and again with ``FILODB_SIDECARS=0`` (the decode
   lane: B1/B2/B4), each cold and warm with its GETs and payload bytes, and
   an interior-only window that must page no payload; every kernel must
   launch; each pyramid answer must equal the lane off's, and the ``App-0``
   subset of each query the local-disk store's and the CPU's (rtol 2e-5,
   atol 1e-6); ``approx_topk`` and ``approx_cardinality`` under
   ``FILODB_SIDECAR_APPROX=1`` must read no payload, find the largest value
   and count the series within 10 %.
20. Standing queries, in two steps. Step 1, on phase 17's store
   after phase 17 (before its service goes; the phase-2 store under
   ``--rules-only``): a ``RuleManager`` a group
   over a ``MemstoreSink``, a 60 s group (``sum(rate) by (_ns_)``
   recorded, and an alert on it above the median of its fresh-start
   values with ``for: 1m``) and a 10 s group (``sum(sum_over_time[1m]) by
   (job)`` recorded); the fresh-start ticks, 12 scrapes of every series
   through the C++ pass with the 60 s group ticked after every sixth and
   the 10 s group once at the end (a catch-up of 12 steps), an idle tick
   that must evaluate nothing; each tick's ms, steps, lanes and launches
   printed (the ticks must launch a kernel); the recorded series equal to
   the expressions polled over the recorded steps (rtol 2e-5, atol 1e-9),
   the alerts pending or firing as the steps' values give them, and a
   second manager a group that recovers each watermark and the alert
   states and evaluates and skips nothing. Step 2, after phase 12's node
   stopped: a node over phase 11's directory with ``rules.groups``,
   ``selfmon`` (every second) and ``rules.notify.webhook_url`` pointing at
   a receiver in the script; remote read of 100 series equal to the
   shards' exact samples, a scrape of them 60 s on, then the group's
   alerts firing in ``/api/v1/alerts`` and at the webhook,
   ``/api/v1/rules``, ``status/tsdb``, ``status/mesh``, ``status/ingest``'s
   rules lag, ``?stats=all`` with ``decodeMs`` and ``reduceMs`` above 0,
   and ``max(filodb_ingest_lag_seconds)`` from ``_meta``; then a restart
   on the same directory, where the group must resume at its watermark,
   and after two more steps hold one recorded sample a step a namespace.

21. The multi-process mesh runtime, in two steps. Step 1 (after phase 5,
   while the root holds phase 3's batches only and the phase-2 store is
   still phase 2's): ``MP_WORKERS`` mesh worker
   processes on the card, spawned after phase 1 with the seed callable
   ``multiproc_store`` (each ingests the phase-2 generator's series that
   route to its shard slice, beside the root's phase 2), under a
   ``MeshClusterRuntime`` whose root holds the phase-2 store; each of
   ``MP_QUERIES`` at phase 3's grid cold once and warm ``MP_WARM`` times
   through the runtime and through the root's single-process engine, every
   answer bitwise the engine's and routed ``ok``
   (``filodb_mesh_proc_dispatch``); the workers' launches from their
   status (B3 and B1/B2/B4 each above 0: ``launches_phase21``), device
   bytes and the last collective's seconds; ``FILODB_MULTIPROC=0`` parity;
   then one worker killed, and the fallback answer bitwise with
   ``fallback{reason="worker"}`` one up. Step 2 (after phase 20's node):
   a node over phase 11's directory with ``mesh_workers`` (the workers
   recover from its stores and tail its WAL read-only; the extent and
   response caches off), ``MP_NODE_QUERY`` over HTTP routed ``ok`` and
   equal to the node's answer under ``FILODB_MULTIPROC=0``,
   ``status/mesh`` with ``multiproc: true``, then a scrape and a query at
   once (``ok`` or ``stale``), then routed ``ok`` and equal again.

Its last two lines are a JSON object with the kernels' numbers and
``{"ok": true, "device": {...}}``. Run it from the repository root:
``python3 chip_smoke.py`` (``--exec-only``: phases 1, 2 and 10 alone;
``--durability-only``: phases 1, 11, 12 and 13; ``--host-only``: phases 1
and 14; ``--serving-only``: phases 1, 15 and 16; ``--ingest-only``:
phases 1, 2 and 17; ``--longterm-only``: phases 1 and 18;
``--objectstore-only``: phases 1 and 19; ``--rules-only``: phases 1, 2,
11 and 20; ``--multiproc-only``: phases 1, 2, 21 step 1, 11 and 21 step
2).
Without CUDA it exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
T0_MS = 1_700_000_000_000
LONG_QUERIES = (
    ("sum(rate(http_requests_total[5m])) by (_ns_)", "rate", 300_000),
    ("sum(count_over_time(http_requests_total[5m])) by (job)",
     "count_over_time", 300_000),
    ("increase(http_requests_total[1h])", "increase", 3_600_000),
)
QUERIES = (
    ("sum(rate(http_requests_total[5m])) by (_ns_)", "rate"),
    ("increase(http_requests_total[5m])", "increase"),
    ('avg(avg_over_time(http_requests_total{_ns_="App-0"}[2m]))',
     "avg_over_time"),
    ("sum(count_over_time(http_requests_total[5m])) by (job)",
     "count_over_time"),
)

M = "http_requests_total"
# one query of every family the port serves beyond QUERIES: each range
# function, the instant selector, each aggregation, instant functions,
# operators with a number, a join and the set operators
FAMILY_QUERIES = tuple(f"{fn}({M}[5m])" for fn in (
    "min_over_time", "max_over_time", "stddev_over_time", "stdvar_over_time",
    "zscore", "last_over_time", "present_over_time", "changes", "resets",
    "irate", "idelta", "deriv", "sum_over_time", "delta")) + (
    f"timestamp({M})", f"predict_linear({M}[5m], 600)",
    f"quantile_over_time(0.9, {M}[5m])", f"holt_winters({M}[5m], 0.5, 0.5)",
    M, f"{M} offset 5m", f"sum({M}) by (job)", f"group({M}) by (_ns_)",
    f"stddev(rate({M}[5m])) by (job)", f"stdvar(irate({M}[5m]))",
    f"topk(3, rate({M}[5m]))", f"bottomk(2, {M}) by (job)",
    f"quantile(0.9, rate({M}[5m])) by (job)",
    f"abs(deriv({M}[5m]))", f"month(timestamp({M}))", f"{M} % 7 > bool 3",
    f"2 ^ (irate({M}[5m]) / 2)",
    f"sum(rate({M}[5m])) by (_ns_) / on (_ns_) sum(rate({M}[5m] offset 1m)) "
    f"by (_ns_)",
    f"rate({M}[5m]) * on (job) group_left sum(rate({M}[5m])) by (job)",
    f"rate({M}[5m]) > 1 and on (job) {M}{{_ns_=\"App-1\"}}",
    f"irate({M}[5m]) > 1 or rate({M}[5m])",
    f"{M} unless {M} > 5000",
)
# every range function and the instant selector over one namespace's
# 10 k series (phase 7: a warm time for each new path)
_APP0 = f'{M}{{_ns_="App-0"}}'
PER_FUNCTION = {
    **{fn: f"{fn}({_APP0}[5m])" for fn in (
        "min_over_time", "max_over_time", "stddev_over_time",
        "stdvar_over_time", "zscore", "last_over_time", "present_over_time",
        "changes", "resets", "irate", "idelta", "deriv")},
    "predict_linear": f"predict_linear({_APP0}[5m], 600)",
    "quantile_over_time": f"quantile_over_time(0.5, {_APP0}[5m])",
    "holt_winters": f"holt_winters({_APP0}[5m], 0.5, 0.5)",
    "timestamp": f"timestamp({_APP0})",
    "instant selector": _APP0,
}
# the new phase's full-width queries (phase 7)
PROMQL_QUERIES = (
    f"sum({M}) by (job)",
    f'{M}{{_ns_="App-0"}}',
    f"max(max_over_time({M}[5m])) by (_ns_)",
    f"avg(stddev_over_time({M}[5m])) by (job)",
    f"topk(10, rate({M}[5m]))",
    f"sum(irate({M}[5m])) by (_ns_) * 60",
    f'quantile_over_time(0.9, {M}{{_ns_="App-0"}}[5m])',
    f'sum(rate({M}{{job="job-0"}}[5m])) by (_ns_) / sum(rate({M}[5m])) '
    f"by (_ns_)",
)
END_S = T0_MS // 1000 + 7200  # the end of the stores' 2 h
# the plan shapes of phase 9, at full width on the phase-2 store (and on
# phase 5's small store, card against CPU)
PLAN_SHAPES = (
    f'absent({M}{{job="none"}})',
    f"absent_over_time({_APP0}[5m])",
    f'count_values("r", round(rate({M}[5m])))',
    f"sort_desc(sum(rate({M}[5m])) by (_ns_))",
    f'label_replace(sum(rate({M}[5m])) by (job), "j", "$1", "job", '
    f'"job-(.*)")',
    f"limit(100, {_APP0})",
    f"{_APP0} * time()",
    f"scalar(sum(rate({M}[5m])))",
    "vector(1) + 1",
    f"sum(rate({M}[5m] @ {END_S})) by (_ns_)",
    f"max_over_time(sum(rate({M}[5m])) by (_ns_)[30m:1m])",
)
# phase 10: the exec engine at full width on the phase-2 store, each query
# against the mesh engine's answer; the third reads the 2 of 4 shards its
# shard key maps to, the fourth is per series (bitwise between engines)
EXEC_QUERIES = (
    f"sum(rate({M}[5m])) by (_ns_)",
    f"sum(count_over_time({M}[5m])) by (job)",
    f'sum(rate({M}{{_ws_="demo",_ns_="App-0"}}[5m]))',
    f"rate({_APP0}[5m])",
)
EXEC_WARM = 3  # warm runs of each phase-10 query on each engine
# instant queries of phase 9, at the end of the 2 h
INSTANT_QUERIES = (f"sum(rate({M}[5m])) by (_ns_)", _APP0)
# phase 9's instant queries over functions the sidecar lane serves: the
# service's mesh engine hands a one-step grid to exec, whose leaves fold it
# from the chunks' summaries; each runs with the lane forced
# (FILODB_SIDECAR_SEALED_GATE=0) and with the lane off (FILODB_SIDECARS=0:
# mesh, the decode lane), cold and warm, and once at the default gate for
# the lane's own decision
SIDECAR_INSTANT = (f"count(count_over_time({M}[5m]))",
                   f"sum(count_over_time({M}[5m]))",
                   f"sum(rate({M}[5m])) by (_ns_)",
                   f"sum(last_over_time({M}[5m]))")
SIDECAR_VALVES = (("lane", {"FILODB_SIDECAR_SEALED_GATE": "0"}),
                  ("default gate", {}),
                  ("decode lane", {"FILODB_SIDECARS": "0"}))
# aggregations over an operator or an instant function (phase 7), each with
# the query it must equal times a factor: their group ids come from the
# leaf's cached keys, so a warm one costs about what its plain form does
MAPPED_QUERIES = (
    (f"sum(rate({M}[5m]) * 8) by (job)", f"sum(rate({M}[5m])) by (job)", 8.0),
    (f"sum(abs({M})) by (job)", PROMQL_QUERIES[0], 1.0),
)


def keys_group_ids(eng, amr, keys):
    """The engine's cached group ids of ``keys`` under aggregation
    ``amr``."""
    return eng.gids.keys_group_ids(amr, keys, eng.device)


def log(msg: str) -> None:
    print(msg, flush=True)


class valves:
    """Environment variables set for a ``with`` block (the lane's
    valves, read at query time), restored after it."""

    def __init__(self, **env):
        self.env = env

    def __enter__(self):
        import os

        self.saved = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        import os

        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def on_mesh(res, q: str):
    """``res``, the answer to ``q``, which the mesh engine must have served:
    no shape moves to the exec engine unnoticed."""
    if res.stats.engine != "mesh":
        raise AssertionError(f"{q}: served by the {res.stats.engine} engine, "
                             f"not mesh ({res.stats.fallback})")
    return res


def make_series(rng, a: int, b: int, samples: int,
                stale_every: int | None = None):
    """Series a..b-1: labels, jittered timestamps, counters with resets,
    and stale markers: in about 2 % of series (or in every
    ``stale_every``-th), one run of 3-6 NaN samples at a random place, a
    scrape target that vanished and came back."""
    n = b - a
    labels = [{"_metric_": "http_requests_total", "_ws_": "demo",
               "_ns_": f"App-{i % 100}", "instance": f"instance-{i}",
               "job": f"job-{i % 10}"} for i in range(a, b)]
    ts = (T0_MS + np.arange(samples, dtype=np.int64)[None, :] * 10_000
          + rng.integers(-500, 501, (n, samples)))
    vals = np.cumsum(rng.integers(0, 20, (n, samples)), axis=1).astype(
        np.float64)
    reset = np.flatnonzero(rng.random(n) < 0.05)
    at = rng.integers(1, samples, len(reset))
    for r, k in zip(reset, at):
        vals[r, k:] -= vals[r, k]
    stale = np.flatnonzero(rng.random(n) < 0.02) if stale_every is None \
        else np.arange(0, n, stale_every)
    at = rng.integers(30, samples - 6, len(stale))  # after the first 5 min
    run = rng.integers(3, 7, len(stale))
    for r, k, m in zip(stale, at, run):
        vals[r, k : k + m] = np.nan
    return labels, ts, vals


def ingest(store, series: int, samples: int, seed: int,
           stale_every: int | None = None) -> int:
    rng = np.random.default_rng(seed)
    kept = 0
    step = 65536
    for a in range(0, series, step):
        kept += store.ingest_series(*make_series(
            rng, a, min(a + step, series), samples, stale_every))
    return kept


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_time_ms(fn, reps: int) -> float | None:
    """Mean device time of ``fn`` a call over ``reps`` calls, from a
    ``torch.profiler`` trace: the device time of every kernel and copy it
    launched, without the host's gaps between launches. None where the
    trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0) or 0
             for e in prof.key_averages())
    return us / 1000.0 / reps if us > 0 else None


def top_device_ops(fn, reps: int, k: int = 8) -> dict:
    """The device time of ``fn`` a call and its ``k`` largest kernels and
    copies by device time (ms a call), from a ``torch.profiler`` trace of
    the device alone: each kernel counts once, not again under the
    operator that launched it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = sorted(((getattr(e, "self_device_time_total", 0) or 0, e.key)
                  for e in prof.key_averages()), reverse=True)
    return {"device_ms": sum(us for us, _ in ops) / 1000.0 / reps,
            "top_ms": {name[:80]: us / 1000.0 / reps for us, name in ops[:k]
                       if us > 0}}


def host_split(fn, reps: int, k: int = 10) -> dict:
    """Host seconds of ``fn`` by function, from ``cProfile`` over ``reps``
    calls: the ``k`` largest self times, ms a call (the device's work
    shows where the host waits on it)."""
    import cProfile
    import pstats

    fn()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(reps):
        fn()
    prof.disable()
    st = pstats.Stats(prof).stats
    top = sorted(((v[2], f"{Path(f[0]).name}:{f[1]}:{f[2]}")
                  for f, v in st.items()), reverse=True)[:k]
    return {name: sec * 1000.0 / reps for sec, name in top}


def split_times(parts: dict, reps: int, rounds: int) -> dict:
    """Per part of a split: the median over ``rounds`` of ``cuda_time_ms``
    (host launch gaps included), the spread of those rounds, and the
    profiler's device time."""
    out = {}
    for name, f in parts.items():
        ev = sorted(cuda_time_ms(f, reps) for _ in range(rounds))
        out[name] = {"events_ms": float(np.median(ev)),
                     "events_min_ms": ev[0], "events_max_ms": ev[-1],
                     "device_ms": device_time_ms(f, reps)}
    return out


def wall_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1000.0


def compare(got, want, rtol: float, atol: float, bitwise: bool = False):
    """(max_abs_err, ok): NaN positions must agree."""
    import torch

    if bitwise:
        a = got.contiguous().view(torch.int32)
        b = want.contiguous().view(torch.int32)
        diff = (got.double() - want.double()).abs()
        diff = diff[torch.isfinite(diff)]
        err = float(diff.max()) if diff.numel() else 0.0
        return err, bool(torch.equal(a, b))
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    both = ~nan_g & ~nan_w
    g, w = got[both].double(), want[both].double()
    err = float((g - w).abs().max()) if g.numel() else 0.0
    ok = bool(torch.equal(nan_g, nan_w)) and bool(
        ((g - w).abs() <= atol + rtol * w.abs()).all())
    return err, ok


# Operations each kernel does on its data, counted from the .cu bodies
# (loop control and address arithmetic left out). The card's table gives no
# integer rate, so integer operations are charged at the float32 rate.
# common.cuh unpack_field: w==0 test, lane*w, >>5, &31, wi+1 and its clamp
# (3), funnelshift, w>=32, 1<<w, -1, select, &.
UNPACK_OPS = 13
# common.cuh unpack_four, per lane (four fields): 4j*w, &31, four funnel
# shifts, 2w and 3w, field 0's & (1), field 1's shift and & (2), field 2's
# compare, subtract, three selects, shift and & (7), field 3's two
# compares, two subtracts, three selects, shift and & (9).
UNPACK_FOUR_OPS = 1 + 1 + 4 + 2 + 1 + 2 + 7 + 9
# decode_pages.cu, per lane of a block: the width mask (w==0, w>=32, 1<<w,
# -1, two selects), unpack_four, then per field B1: unzigzag (>>, &,
# negate, ^), slope*i, +; B2: <<, select, ^ first, and tz>=32 once.
WIDTH_MASK_OPS = 6
B1_OPS_BLOCK = 32 * (WIDTH_MASK_OPS + UNPACK_FOUR_OPS + 4 * 6)
B2_OPS_BLOCK = 32 * (WIDTH_MASK_OPS + UNPACK_FOUR_OPS + 1 + 4 * 3)
# fused_rate.cu, per sample: valid test, two unpacks, unzigzag (4),
# base+slope*lane+resid (3), float decode (4), four selects, scans at eight
# operations a sample, counter correction (5) and v+cv. (This is the count
# of the kernel that held a series in one CTA with four scans; the
# streaming kernel's two warp scans and carries do no fewer, so it stays.)
B3_OPS_SAMPLE = 1 + 2 * UNPACK_OPS + 4 + 3 + 4 + 4 + 4 * 2 + 6
# per step: t-w, window count from the two ordinals (2), extrapolatedRate
# (34), plus 5 an iteration of each of the two binary searches, which run
# over the 128 keys of the block the stream is in.
B3_OPS_STEP = 1 + 2 + 34
# windowed_sum.cu: per sample the pad test and select and the scan (2);
# per step t-w and the two searches over one 128-sample chunk; per window
# sample one +, since a sorted chunk's samples in [lo, hi) skip the mask
# (this run's timestamps are sorted; an unsorted chunk adds two compares
# and an &&).
B4_OPS_SAMPLE, B4_OPS_STEP, B4_OPS_WINDOW_SAMPLE = 4, 1, 1
SEARCH_OPS = 5
SEARCH_KEYS = 128  # keys a binary search of B3 and B4 runs over


def search_iters(S: int) -> int:
    """Iterations of common.cuh upper_bound over S keys."""
    return S.bit_length()


def word_bytes(widths) -> int:
    """Bytes of packed words the blocks' widths need: 4*w words a block."""
    return 16 * int(widths.long().sum())


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def decode_cases(part) -> tuple:
    """B1 and B2 on one decode chunk of packed rows, as ``assemble`` calls
    them: (name, TPU kernel replaced, kernel, plain version, bytes,
    operations) each. Bytes are the per-block scalars, the words the widths
    need and the output."""
    from filodb_tpu_torch.memory import device_pages as dp
    from filodb_tpu_torch.query.engine.device_batch import BLOCK

    sl, tw = part[1].reshape(-1), part[2].reshape(-1)
    tw_words = part[3].reshape(-1, BLOCK)
    vf, vs, vw = (part[i].reshape(-1) for i in (4, 5, 6))
    vw_words = part[7].reshape(-1, BLOCK)
    nb = tw.numel()
    return (
        ("decode_ts_page", "filodb_tpu/memory/device_pages.py:262",
         lambda: dp.decode_ts_blocks(sl, tw, tw_words),
         lambda: dp.decode_ts_blocks_plain(sl, tw, tw_words),
         nb * (8 + 512) + word_bytes(tw), nb * B1_OPS_BLOCK),
        ("decode_f32_page", "filodb_tpu/memory/device_pages.py:307",
         lambda: dp.decode_f32_blocks(vf, vs, vw, vw_words),
         lambda: dp.decode_f32_blocks_plain(vf, vs, vw, vw_words),
         nb * (12 + 512) + word_bytes(vw), nb * B2_OPS_BLOCK),
    )


def over_time_split(part, range_len: int, steps, window: int, flight: int,
                    reps: int) -> dict:
    """CUDA-event ms of each part of one count_over_time decode chunk, in
    the order ``mesh_engine`` runs them, and of the whole chunk."""
    import torch

    from filodb_tpu_torch.query.engine import cuda_kernels as ck
    from filodb_tpu_torch.query.engine.device_batch import fill_gaps

    (_, _, b1, *_), (_, _, b2, *_) = decode_cases(part)
    nan = torch.tensor(float("nan"), device=part[0].device)

    def glue(off, vals):  # assemble after B1/B2: base add, validity,
        ts, _, valid = fill_gaps(part[0], part[8], off, vals)  # cummax
        return ts, valid & (ts >= 0) & (ts <= range_len)  # and range

    def pad_cast(ts, valid):
        return (torch.where(valid, ts, ck.TS_PAD).contiguous(),
                valid.to(torch.float32))

    def b4(ts, ones):
        return ck.windowed_sum(ts, ones, steps, window, flight)

    def nan_select(cnt):
        return torch.where(cnt > 0, cnt, nan)

    off, vals = b1(), b2()
    ts, valid = glue(off, vals)
    padded, ones = pad_cast(ts, valid)
    cnt = b4(padded, ones)
    parts = {"B1": b1, "B2": b2,
             "assemble_glue": lambda: glue(off, vals),
             "pad_cast": lambda: pad_cast(ts, valid),
             "B4": lambda: b4(padded, ones),
             "nan_select": lambda: nan_select(cnt)}
    out = {k: cuda_time_ms(f, reps) for k, f in parts.items()}
    out["sum_of_parts"] = sum(out.values())
    out["chunk"] = cuda_time_ms(
        lambda: nan_select(b4(*pad_cast(*glue(b1(), b2())))), reps)
    out["rows"], out["S"] = int(ts.shape[0]), int(ts.shape[1])
    return out


def check_kernels(svc, reps: int) -> list[dict]:
    """Phase 4: each kernel at the main path's shapes, against its plain
    version on the same inputs."""
    import torch

    from filodb_tpu_torch import _build
    from filodb_tpu_torch.query.exec.transformers import decode_rows
    from filodb_tpu_torch.query.engine import cuda_kernels as ck
    from filodb_tpu_torch.query.engine.device_batch import (
        BLOCK,
        assemble,
    )

    eng = svc.mesh
    big = max(eng.batches.batches("mesh"), key=lambda b: len(b.keys))
    packed = big.packed
    P, NB = packed[0].shape
    n_series = len(big.keys)
    K = 121
    steps = torch.arange(300_000, 300_000 + K * 60_000, 60_000,
                         dtype=torch.int32, device=svc.device)
    window = 300_000
    flight = ck.steps_in_flight(steps.cpu(), window)  # as the engine does
    saved = dict(_build.LAUNCHES)
    out = []

    # B1 / B2 on one decode chunk of the B4 path, as assemble calls them
    rows = min(decode_rows(NB * BLOCK), n_series)
    part = tuple(t[:rows] for t in packed)
    nb = rows * NB
    for name, repl, run, plain, nbytes, ops in decode_cases(part):
        got, want = run(), plain()
        err, ok = compare(got, want, 0, 0, bitwise=True)
        if not ok:
            raise AssertionError(f"{name} differs from its plain version")
        b, by = bound_ms(nbytes, ops)
        out.append(dict(name=name, route="cuda",
                        source="filodb_tpu_torch/csrc/decode_pages.cu",
                        replaces=repl, shape=f"{nb} blocks",
                        tolerance="bitwise", max_abs_err=err,
                        ms=cuda_time_ms(run, reps),
                        plain_ms=wall_ms(plain), bound_ms=b, bound_by=by,
                        library_ms=None, bound_bytes=nbytes, bound_ops=ops))
        log(f"  {name}: {nb} blocks bitwise equal to plain")

    # B3 on the whole batch of the rate query
    got = ck.fused_decode_rate(packed, steps, window, "rate", True)
    want = plain_b3(packed, steps, window, "rate")
    err, ok = compare(got, want, 1e-6, 1e-6)
    if not ok:
        raise AssertionError(f"fused_decode_rate off by {err}")
    # bytes: the seven per-block scalar arrays, the words the ts and value
    # widths need, the steps and the output; operations on valid samples
    nbytes = (sum(packed[i].numel() * 4 for i in (0, 1, 2, 4, 5, 6, 8))
              + word_bytes(packed[2]) + word_bytes(packed[6])
              + K * 4 + P * K * 4)
    ops = (int(packed[8].long().sum()) * B3_OPS_SAMPLE
           + P * K * (B3_OPS_STEP
                      + 2 * SEARCH_OPS * search_iters(SEARCH_KEYS)))
    b, by = bound_ms(nbytes, ops)
    out.append(dict(
        name="fused_decode_rate", route="cuda",
        source="filodb_tpu_torch/csrc/fused_rate.cu",
        replaces="filodb_tpu/query/engine/pallas_kernels.py:231",
        shape=f"P={P} NB={NB} K={K}", tolerance="rtol 1e-6, atol 1e-6",
        max_abs_err=err,
        ms=cuda_time_ms(lambda: ck.fused_decode_rate(
            packed, steps, window, "rate", True, flight), reps),
        plain_ms=wall_ms(lambda: plain_b3(packed, steps, window, "rate")),
        bound_ms=b, bound_by=by, library_ms=None, bound_bytes=nbytes,
        bound_ops=ops))
    log(f"  fused_decode_rate: P={P} NB={NB} K={K}, max abs err {err:g} "
        f"(tolerance rtol 1e-6 atol 1e-6)")
    rate_plain = want[:n_series]

    # B4 on one decode chunk, as the avg/count_over_time leaves call it
    ts, vals, valid = assemble(part, 7_500_000)
    ts = torch.where(valid, ts, ck.TS_PAD).contiguous()
    v0 = torch.where(valid, vals, 0.0).contiguous()
    got = ck.windowed_sum(ts, v0, steps, window)
    want = ck.windowed_sum_plain(ts, v0, steps, window)
    err, ok = compare(got, want, 0, 0, bitwise=True)
    if not ok:
        raise AssertionError("windowed_sum differs from its plain version")

    def window_bounds():
        key = torch.cummax(torch.where(ts == ck.TS_PAD, -(2**31), ts),
                           1).values
        t = steps[None, :].expand(rows, -1).contiguous()
        return (torch.searchsorted(key, t - window, right=True),
                torch.searchsorted(key, t, right=True))

    def library():
        # nearest PyTorch yardstick: prefix sums + searchsorted + gathers
        csum = torch.nn.functional.pad(torch.cumsum(v0, 1), (1, 0))
        lo, hi = window_bounds()
        return csum.gather(1, hi) - csum.gather(1, lo)

    S = ts.shape[1]
    lo, hi = window_bounds()
    nbytes = rows * S * 8 + K * 4 + rows * K * 4
    ops = (rows * S * B4_OPS_SAMPLE
           + rows * K * (B4_OPS_STEP
                         + 2 * SEARCH_OPS * search_iters(SEARCH_KEYS))
           + int((hi - lo).sum()) * B4_OPS_WINDOW_SAMPLE)
    b, by = bound_ms(nbytes, ops)
    out.append(dict(
        name="windowed_sum", route="cuda",
        source="filodb_tpu_torch/csrc/windowed_sum.cu",
        replaces="filodb_tpu/query/engine/pallas_kernels.py:49",
        shape=f"P={rows} S={S} K={K}", tolerance="bitwise (same order)",
        max_abs_err=err,
        ms=cuda_time_ms(lambda: ck.windowed_sum(ts, v0, steps, window,
                                                flight), reps),
        plain_ms=wall_ms(lambda: ck.windowed_sum_plain(ts, v0, steps,
                                                       window)),
        bound_ms=b, bound_by=by, library_ms=cuda_time_ms(library, reps),
        library_call="cumsum + cummax + searchsorted + gather",
        bound_bytes=nbytes, bound_ops=ops))
    log(f"  windowed_sum: P={rows} S={S} K={K} bitwise equal to plain")
    split = over_time_split(part, 7_500_000, steps, window, flight, reps)
    log(f"  over_time chunk split (ms, CUDA events): {json.dumps(split)}")
    _build.LAUNCHES.update(saved)  # comparison launches are not counted
    return out, rate_plain


def plain_b3(packed, steps, window: int, kind: str):
    """B3's plain version over a batch, in row chunks of 2^26 samples."""
    import torch

    from filodb_tpu_torch.query.engine import cuda_kernels as ck

    P, NB = packed[0].shape
    rows = max(1, 2**26 // (NB * 128))
    return torch.cat([ck.fused_decode_rate_plain(
        tuple(t[a : a + rows] for t in packed), steps, window, kind, True)
        for a in range(0, P, rows)])


def lowered(eng, q: str, start: int, end: int):
    """(the lowered leaf of query ``q``, the engine's aggregation above it
    or None), as the engine ``eng`` evaluates them."""
    from filodb_tpu_torch.parallel.mesh_engine import lower_plan
    from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query
    from filodb_tpu_torch.query import logical as lp

    plan = parse_query(q, TimeStepParams(start, 60, end))
    if not isinstance(plan, lp.Aggregate):
        return lower_plan(plan), None
    return lower_plan(plan.vector), eng._aggregation(plan)


def leaf_steps(low):
    """A lowered leaf's steps as the engine hands them to the card: int32
    ms relative to the start of its data range, on the host."""
    import torch

    from filodb_tpu_torch.query.exec.transformers import steps_array

    rel = steps_array(low.start, low.step, low.end) - low.offset \
        - low.chunk_range[0]
    return torch.from_numpy(rel.astype(np.int32))


def agrees_with_plain(svc, q: str, start: int, end: int, got,
                      per_series) -> bool:
    """A query's answer against the plain per-series results [n, K],
    aggregated as the engine aggregates them."""
    from filodb_tpu_torch.query.engine.aggregations import aggregate

    eng = svc.mesh
    low, amr = lowered(eng, q, start, end)
    batch = eng._batch(svc.memstore, low)
    leaf_keys = batch.keys if low.keep_metric else batch.out_keys
    if amr is None:
        want, keys = per_series.cpu().double().numpy(), leaf_keys
    else:
        gids, keys = keys_group_ids(eng, amr, leaf_keys)
        want = aggregate(amr.op, per_series, gids, len(keys)).cpu().numpy()
    order = {str(k): i for i, k in enumerate(keys)}
    idx = [order[str(k)] for k in got.keys]
    return got.values.shape[1] == want.shape[1] and np.allclose(
        got.values, want[idx], rtol=1e-5, atol=1e-6, equal_nan=True)


def long_range(dev, args, reps: int) -> dict:
    """Phase 6: 48 h series through B3 and B4 (NB = 256, K = 2,881)."""
    import torch

    from filodb_tpu_torch import _build
    from filodb_tpu_torch.core.memstore.memstore import MemStore
    from filodb_tpu_torch.query.exec.transformers import decode_rows
    from filodb_tpu_torch.query.engine import cuda_kernels as ck
    from filodb_tpu_torch.query.engine.device_batch import BLOCK, assemble

    t = t_phase = time.perf_counter()
    store = MemStore(num_shards=4, spread=1, max_chunk_size=400)
    kept = ingest(store, args.long_series, args.long_samples, args.seed + 2)
    log(f"phase 6: long ranges: {args.long_series} series x "
        f"{args.long_samples} samples ({kept} samples), ingest "
        f"{time.perf_counter() - t:.1f} s on the host")
    svc = smoke_service(store, device=dev)
    start = T0_MS // 1000
    end = start + args.long_samples * 10
    _build.reset_counts()
    results = {}
    for q, _, _ in LONG_QUERIES:
        t = time.perf_counter()
        results[q] = svc.query_range(q, start, 60, end)
        cold = (time.perf_counter() - t) * 1000.0
        t = time.perf_counter()
        r = svc.query_range(q, start, 60, end)
        warm = (time.perf_counter() - t) * 1000.0
        log(f"  {q}: cold {cold:.1f} ms, warm {warm:.2f} ms, "
            f"{r.result.num_series} x {r.result.num_steps}")
    launches = dict(_build.LAUNCHES)
    log(f"  launches in the phase: {launches}")
    if dev.type == "cuda" and not (launches["fused_decode_rate"]
                                   and launches["windowed_sum"]):
        raise AssertionError("long ranges did not run through B3 and B4")

    eng = svc.mesh
    steps_ms = np.arange(start * 1000, end * 1000 + 1, 60_000)
    K = len(steps_ms)
    out = {"series": args.long_series, "samples": args.long_samples,
           "K": K, "kernels": []}
    for q, fn, w in LONG_QUERIES:
        low, _ = lowered(eng, q, start, end)
        batch = eng._batch(store, low)
        packed = batch.packed
        P, NB = packed[0].shape
        n = len(batch.keys)
        host = torch.from_numpy((steps_ms - low.chunk_range[0]).astype(
            np.int32))
        flight = ck.steps_in_flight(host, w)
        steps = host.to(dev)
        if fn in ("rate", "increase"):
            def run():
                return ck.fused_decode_rate(packed, steps, w, fn, True,
                                            flight)
            got, want = run(), plain_b3(packed, steps, w, fn)
            err, ok = compare(got, want, 1e-6, 1e-6)
            per_series = want[:n]
            name, shape, tol = ("fused_decode_rate", f"P={P} NB={NB} K={K}",
                                "rtol 1e-6, atol 1e-6")
        else:
            rows = min(decode_rows(NB * BLOCK), n)
            cnts, ok, err = [], True, 0.0
            for a in range(0, n, rows):
                ts, vals, valid = assemble(tuple(t[a : a + rows]
                                                 for t in packed),
                                           low.chunk_range[1]
                                           - low.chunk_range[0])
                ts = torch.where(valid, ts, ck.TS_PAD).contiguous()
                ones = valid.to(torch.float32)
                got = ck.windowed_sum(ts, ones, steps, w)
                want = ck.windowed_sum_plain(ts, ones, steps, w)
                e, same = compare(got, want, 0, 0, bitwise=True)
                ok, err = ok and same, max(err, e)
                cnts.append(torch.where(want > 0, want, float("nan")))
                if a == 0:
                    def run(ts=ts, ones=ones):
                        return ck.windowed_sum(ts, ones, steps, w, flight)
                    shape = f"P={ts.shape[0]} S={ts.shape[1]} K={K}"
            per_series = torch.cat(cnts)
            name, tol = "windowed_sum", "bitwise (same order)"
        if not ok:
            raise AssertionError(f"{name} differs from its plain version on "
                                 f"{q} (max abs err {err})")
        if not agrees_with_plain(svc, q, start, end, results[q].result,
                                 per_series):
            raise AssertionError(f"{q} disagrees with the plain path")
        ms = cuda_time_ms(run, reps)
        out["kernels"].append(dict(name=name, query=q, shape=shape,
                                   tolerance=tol, max_abs_err=err, ms=ms))
        log(f"  {name} on {q}: {shape}, {ms:.4f} ms, max abs err {err:g} "
            f"({tol}); answer equal to the plain path")
    _build.LAUNCHES.update(launches)  # comparison launches are not counted
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 6 took {out['seconds']:.1f} s")
    return out


def small_store_check(seed: int, dev) -> None:
    """The same small store answers the same on the card and on the CPU."""
    from filodb_tpu_torch.core.memstore.memstore import MemStore

    store = MemStore(4, 1, 400)
    ingest(store, 256, 720, seed + 1, stale_every=2)
    gpu, cpu = smoke_service(store, dev), smoke_service(store, device="cpu")
    queries = [q for q, _ in QUERIES] + list(FAMILY_QUERIES) \
        + list(PLAN_SHAPES)
    for q in queries:
        a = gpu.query_range(q, T0_MS // 1000, 60, END_S)
        b = cpu.query_range(q, T0_MS // 1000, 60, END_S)
        ka = [str(k) for k in a.result.keys]
        kb = [str(k) for k in b.result.keys]
        if ka != kb or not np.allclose(a.result.values, b.result.values,
                                       rtol=2e-5, atol=1e-6,
                                       equal_nan=True):
            raise AssertionError(f"card and CPU disagree on {q}")
    log(f"  small store (stale markers in every other series): card and "
        f"CPU answers agree on {len(queries)} queries (rtol 2e-5, atol "
        f"1e-6)")


def decoded_against_plain(svc, q: str, start: int, end: int, got) -> dict:
    """Query ``q`` (an aggregation of one leaf that runs in float64 on
    decoded rows) against the plain path, chunk by chunk as the engine
    cuts its batch (``decode_rows``, the last chunk short): B1 and B2 must
    equal their plain versions bit for bit on every chunk, and the answer
    must equal plain decode plus the float64 function, aggregated as the
    engine aggregates."""
    import torch

    from filodb_tpu_torch.device import EXACT_DTYPE
    from filodb_tpu_torch.query.exec.transformers import decode_rows
    from filodb_tpu_torch.query.engine.device_batch import BLOCK, fill_gaps
    from filodb_tpu_torch.query.engine.kernels import range_eval_masked

    low, _ = lowered(svc.mesh, q, start, end)
    batch = svc.mesh._batch(svc.memstore, low)
    n = len(batch.keys)
    rows = min(decode_rows(batch.packed[0].shape[1] * BLOCK, low.fn), n)
    lo_ms, hi_ms = low.chunk_range
    steps = leaf_steps(low).to(svc.device)
    outs = []
    for a in range(0, n, rows):
        part = tuple(t[a : min(a + rows, n)] for t in batch.packed)
        (n1, _, b1, p1, *_), (n2, _, b2, p2, *_) = decode_cases(part)
        off, vals = p1(), p2()
        for name, run, want in ((n1, b1, off), (n2, b2, vals)):
            if not compare(run(), want, 0, 0, bitwise=True)[1]:
                raise AssertionError(f"{name} differs from its plain version "
                                     f"on rows {a}.. of {q}")
        ts, v, valid = fill_gaps(part[0], part[8], off, vals)
        valid = valid & (ts >= 0) & (ts <= hi_ms - lo_ms)
        outs.append(range_eval_masked(low.fn, ts, v, valid, steps,
                                      low.window, dtype=EXACT_DTYPE))
    if not agrees_with_plain(svc, q, start, end, got, torch.cat(outs)):
        raise AssertionError(f"{q} disagrees with plain decode and the "
                             f"float64 function")
    chunks = -(-n // rows)
    return {"series": n, "rows": rows, "chunks": chunks,
            "last_rows": n - (chunks - 1) * rows}


def rate_against_plain(svc, q: str, start: int, end: int, got) -> dict:
    """Query ``q`` (an aggregation of one rate leaf) against the plain path:
    B3 must match its plain version on the leaf's batch, and the answer the
    plain rates aggregated as the engine aggregates."""
    from filodb_tpu_torch.query.engine import cuda_kernels as ck

    low, _ = lowered(svc.mesh, q, start, end)
    batch = svc.mesh._batch(svc.memstore, low)
    host = leaf_steps(low)
    steps = host.to(svc.device)
    got_b3 = ck.fused_decode_rate(batch.packed, steps, low.window, low.fn,
                                  True, ck.steps_in_flight(host, low.window))
    want = plain_b3(batch.packed, steps, low.window, low.fn)
    err, ok = compare(got_b3, want, 1e-6, 1e-6)
    if not ok:
        raise AssertionError(f"fused_decode_rate off by {err} on {q}")
    if not agrees_with_plain(svc, q, start, end, got, want[:len(batch.keys)]):
        raise AssertionError(f"{q} disagrees with the plain path")
    P, NB = batch.packed[0].shape
    return {"shape": f"P={P} NB={NB} K={steps.numel()}", "max_abs_err": err}


def decoded_split(svc, low, rows: int, reps: int) -> dict:
    """CUDA-event ms of each part of one decode chunk of ``rows`` series
    of a lowered leaf that runs in float64 on decoded rows: B1, B2,
    ``assemble``'s glue, the function, and the whole chunk."""
    from filodb_tpu_torch.query.exec.transformers import decoded_fn
    from filodb_tpu_torch.query.engine.device_batch import fill_gaps

    batch = svc.mesh._batch(svc.memstore, low)
    part = tuple(t[:rows] for t in batch.packed)
    lo_ms, hi_ms = low.chunk_range
    steps = leaf_steps(low).to(svc.device)
    (_, _, b1, *_), (_, _, b2, *_) = decode_cases(part)

    def glue(off, vals):
        ts, v, valid = fill_gaps(part[0], part[8], off, vals)
        return ts, v, valid & (ts >= 0) & (ts <= hi_ms - lo_ms)

    def fn(ts, v, valid):
        return decoded_fn(low.fn, low.params, low.window, ts, v, valid,
                          steps, 0)

    off, vals = b1(), b2()
    decoded = glue(off, vals)
    parts = {"B1": b1, "B2": b2, "assemble_glue": lambda: glue(off, vals),
             low.fn: lambda: fn(*decoded)}
    out = {k: cuda_time_ms(f, reps) for k, f in parts.items()}
    out["sum_of_parts"] = sum(out.values())
    out["chunk"] = cuda_time_ms(lambda: fn(*glue(b1(), b2())), reps)
    out["rows"], out["S"] = int(part[0].shape[0]), int(decoded[0].shape[1])
    return out


def promql_phase(svc, args) -> dict:
    """Phase 7: the rest of PromQL on the phase-2 store, at full width."""
    import torch

    from filodb_tpu_torch import _build

    t_phase = time.perf_counter()
    start, end = T0_MS // 1000, T0_MS // 1000 + 7200
    log("phase 7: the rest of PromQL on the phase-2 store (query_range, "
        "2 h at 60 s):")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    results, timings = {}, []
    for q in PROMQL_QUERIES + tuple(m for m, _, _ in MAPPED_QUERIES):
        t = time.perf_counter()
        r = on_mesh(svc.query_range(q, start, 60, end), q)
        cold = (time.perf_counter() - t) * 1000.0
        warm = []
        for _ in range(3):
            t = time.perf_counter()
            r = svc.query_range(q, start, 60, end)
            warm.append((time.perf_counter() - t) * 1000.0)
        results[q] = r.result
        timings.append(dict(query=q, cold_ms=cold,
                            warm_p50_ms=float(np.median(warm)),
                            rows=r.result.num_series))
        log(f"  {q}: cold {cold:.1f} ms, warm p50 {np.median(warm):.2f} "
            f"ms, {r.result.num_series} rows")
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches in the phase: {launches}; peak device memory "
        f"{peak / 1e9:.2f} GB (max_memory_allocated)")
    if svc.device.type == "cuda" and not (
            launches["decode_ts_page"] and launches["decode_f32_page"]
            and launches["fused_decode_rate"]):
        raise AssertionError("phase 7 did not run through B1/B2 and B3")

    # answers: shapes, finite where data exist, the join against its sides
    n_ns, n_job = min(100, args.series), min(10, args.series)
    app0 = len(range(0, args.series, 100))
    want_shape = {PROMQL_QUERIES[0]: (n_job, 121),
                  PROMQL_QUERIES[1]: (app0, 121),
                  PROMQL_QUERIES[2]: (n_ns, 121),
                  PROMQL_QUERIES[3]: (n_job, 121),
                  PROMQL_QUERIES[5]: (n_ns, 121),
                  PROMQL_QUERIES[6]: (app0, 121)}
    for q, shape in want_shape.items():
        v = results[q].values
        if v.shape != shape or not np.isfinite(v[:, 1:]).all():
            raise AssertionError(f"{q}: shape {v.shape}, want {shape}, "
                                 f"finite after the first step")
    if not all(dict(k.labels).get("_metric_") == M
               for k in results[PROMQL_QUERIES[1]].keys):
        raise AssertionError("the bare selector lost its metric label")
    top = results[PROMQL_QUERIES[4]].values
    if not (np.isfinite(top[:, 1:]).sum(0) == min(10, args.series)).all():
        raise AssertionError("topk(10) does not give 10 series a step")
    q8 = PROMQL_QUERIES[7]
    lhs_q, rhs_q = q8.split(" / ")
    lhs = svc.query_range(lhs_q, start, 60, end).result
    rhs = svc.query_range(rhs_q, start, 60, end).result
    by_ns = {str(k): i for i, k in enumerate(rhs.keys)}
    quot = lhs.values / rhs.values[[by_ns[str(k)] for k in lhs.keys]]
    got = results[q8]
    order = {str(k): i for i, k in enumerate(got.keys)}
    if sorted(order) != sorted(str(k) for k in lhs.keys) \
            or len(order) != min(10, args.series) \
            or not np.allclose(got.values[[order[str(k)] for k in lhs.keys]],
                               quot, rtol=1e-12, atol=0, equal_nan=True):
        raise AssertionError("the join differs from the quotient of its "
                             "sides")
    for q, base, factor in MAPPED_QUERIES:
        base_r = svc.query_range(base, start, 60, end).result
        if [str(k) for k in results[q].keys] != [str(k) for k in base_r.keys] \
                or not np.allclose(results[q].values, factor * base_r.values,
                                   rtol=1e-12, atol=0, equal_nan=True):
            raise AssertionError(f"{q} differs from {factor} x {base}")
    log(f"  answers: shapes, finite values, topk's 10 a step, the bare "
        f"selector's metric label, the join ({len(order)} namespaces, "
        f"equal to its sides' quotient) and the aggregations over an "
        f"operator or function (equal to their plain forms) checked")

    # against the plain path at the shapes the engine gave the kernels
    plain = {q: decoded_against_plain(svc, q, start, end, results[q])
             for q in (PROMQL_QUERIES[2], PROMQL_QUERIES[0])}
    for q, r in plain.items():
        log(f"  {q}: B1 and B2 bitwise equal to plain on {r['chunks']} "
            f"chunks of {r['rows']} rows (last {r['last_rows']}); answer "
            f"equal to plain decode + float64 function (rtol 1e-5)")
    for side, r in ((lhs_q, lhs), (rhs_q, rhs)):
        plain[side] = rate_against_plain(svc, side, start, end, r)
        log(f"  {side}: B3 at {plain[side]['shape']} max abs err "
            f"{plain[side]['max_abs_err']:g} (rtol 1e-6, atol 1e-6); answer "
            f"equal to the plain path (rtol 1e-5)")

    per_fn = {}
    for name, q in PER_FUNCTION.items():
        svc.query_range(q, start, 60, end)
        per_fn[name] = wall_ms(lambda: svc.query_range(q, start, 60, end))
    log(f"  warm ms a function over App-0's {app0} series: "
        f"{json.dumps(per_fn)}")

    splits = {}
    for q in (PROMQL_QUERIES[2], PROMQL_QUERIES[0]):
        low, _ = lowered(svc.mesh, q, start, end)
        split = decoded_split(svc, low, plain[q]["rows"], reps=5)
        splits[low.fn] = split
        log(f"  {low.fn} chunk split at the engine's rows (ms, CUDA "
            f"events): {json.dumps(split)}")
    # the checks' and the split's launches are not counted
    _build.LAUNCHES.update(launches)
    seconds = time.perf_counter() - t_phase
    log(f"  phase 7 took {seconds:.1f} s")
    return {"queries": timings, "launches": launches,
            "peak_bytes": int(peak), "plain_checks": plain,
            "per_function_ms": per_fn, "splits": splits, "seconds": seconds}


def plan_shapes_phase(svc, args) -> dict:
    """Phase 9: the plan shapes beside the leaves, instant queries and the
    metadata calls, on the phase-2 store at full width."""
    import torch

    from filodb_tpu_torch import _build
    from filodb_tpu_torch.http.promjson import scalar_json, vector_json
    from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query

    t_phase = time.perf_counter()
    start, end = T0_MS // 1000, END_S
    log("phase 9: plan shapes, instant queries and metadata on the phase-2 "
        "store:")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    app0 = parse_query(_APP0, TimeStepParams(start, 0, end)).raw.filters
    calls = {q: (lambda q=q: on_mesh(svc.query_range(q, start, 60, end),
                                     q).result)
             for q in PLAN_SHAPES}
    # the lane off: these stay on the mesh engine, as before the lane
    calls.update({f"instant {q}": (lambda q=q: on_mesh(
        _valved(svc.query_instant, {"FILODB_SIDECARS": "0"}, q, end), q))
        for q in INSTANT_QUERIES})
    calls.update({"label_names()": svc.label_names,
                  'label_values("_ns_")': lambda: svc.label_values("_ns_"),
                  'label_values("instance")':
                      lambda: svc.label_values("instance"),
                  'series({_ns_="App-0"})':
                      lambda: svc.series(app0, start, end)})
    results, timings = {}, []
    for name, call in calls.items():
        t = time.perf_counter()
        results[name] = call()
        cold = (time.perf_counter() - t) * 1000.0
        warm = []
        for _ in range(3):
            t = time.perf_counter()
            results[name] = call()
            warm.append((time.perf_counter() - t) * 1000.0)
        timings.append(dict(query=name, cold_ms=cold,
                            warm_p50_ms=float(np.median(warm))))
        log(f"  {name}: cold {cold:.1f} ms, warm p50 "
            f"{np.median(warm):.2f} ms")
    sidecar = sidecar_instants(svc, end)
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches in the phase: {launches}; peak device memory "
        f"{peak / 1e9:.2f} GB (max_memory_allocated)")
    if svc.device.type == "cuda" and not (
            launches["decode_ts_page"] and launches["decode_f32_page"]
            and launches["fused_decode_rate"]):
        raise AssertionError("phase 9 did not run through B1/B2 and B3")

    # answers: shapes and finite values
    n_app0 = len(range(0, args.series, 100))
    n_ns, n_job = min(100, args.series), min(10, args.series)
    (absent, absent_ot, cvals, srt, lrep, lim, times, scal, vec, at,
     sub) = (results[q] for q in PLAN_SHAPES)

    def need(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"phase 9: {what}")

    need(absent.values.shape == (1, 121) and (absent.values == 1).all()
         and absent.keys[0].labels == (("job", "none"),), "absent")
    need(absent_ot.num_series == 0, "absent_over_time of a present series")
    count = svc.query_range(f"count(round(rate({M}[5m])))", start, 60,
                            end).result.values[0]
    need(np.array_equal(np.nansum(cvals.values, 0)[1:], count[1:])
         and all(dict(k.labels)["r"].lstrip("-").isdigit()
                 for k in cvals.keys), "count_values against count")
    last = srt.values[:, -1]
    need(srt.values.shape == (n_ns, 121) and (np.diff(last) <= 0).all(),
         "sort_desc order")
    need(lrep.values.shape == (n_job, 121) and all(
        dict(k.labels)["j"] == dict(k.labels)["job"][4:] for k in lrep.keys),
        "label_replace")
    need(lim.values.shape == (min(100, n_app0), 121), "limit")
    plain = svc.query_range(_APP0, start, 60, end).result
    need([str(k) for k in times.keys] == [str(k.drop_metric())
                                          for k in plain.keys]
         and np.allclose(times.values, plain.values * (
             np.arange(start, end + 1, 60.0)[None, :]), rtol=1e-12,
             equal_nan=True) and np.isfinite(times.values[:, 1:]).all(),
         "an instant selector times time()")
    need(scal.values.shape == (1, 121) and np.isfinite(scal.values[0, 1:])
         .all(), "scalar()")
    need((vec.values == 2).all() and vec.values.shape == (1, 121),
         "vector(1) + 1")
    rng_q = svc.query_range(f"sum(rate({M}[5m])) by (_ns_)", start, 60,
                            end).result
    col = {str(k): rng_q.values[i, -1] for i, k in enumerate(rng_q.keys)}
    want_at = np.array([col[str(k)] for k in at.keys])[:, None]
    need(at.values.shape == (n_ns, 121) and np.allclose(
        at.values, want_at, rtol=1e-6, atol=1e-9), "@ against the range "
         "query's column at the end")
    # the subquery against the float64 function over the inner matrix
    inner_start = (start * 1000 - 1_800_000) // 60_000 * 60_000
    inner = svc.query_range(f"sum(rate({M}[5m])) by (_ns_)",
                            inner_start // 1000, 60, end).result
    steps = np.arange(start, end + 1, 60) * 1000
    in_win = (inner.steps_ms[None, :] > steps[:, None] - 1_800_000) \
        & (inner.steps_ms[None, :] <= steps[:, None])
    vals = np.where(np.isnan(inner.values), -np.inf, inner.values)
    want = np.where(in_win[None], vals[:, None, :], -np.inf).max(2)
    want[want == -np.inf] = np.nan
    order = {str(k): i for i, k in enumerate(inner.keys)}
    want = want[[order[str(k)] for k in sub.keys]]
    need(sub.values.shape == (n_ns, 121)
         and np.isfinite(sub.values[:, 1:]).all()
         and np.allclose(sub.values, want, rtol=1e-12, atol=0,
                         equal_nan=True),
         "the subquery against the float64 max over its inner matrix")
    inst_agg, inst_sel = (results[f"instant {q}"] for q in INSTANT_QUERIES)
    body = vector_json(inst_agg)
    need(inst_agg.result.values.shape == (n_ns, 1)
         and len(body["data"]["result"]) == n_ns and np.allclose(
             inst_agg.result.values[:, 0],
             [col[str(k)] for k in inst_agg.result.keys], rtol=1e-6),
         "instant sum(rate) against the range query's last step")
    need(inst_sel.result.values.shape == (n_app0, 1)
         and np.isfinite(inst_sel.result.values).all(), "instant selector")
    need(scalar_json(svc.query_instant("time()", end))["data"]["result"]
         == [float(end), repr(float(end))], "scalar_json of time()")
    need(results["label_names()"] == ["_metric_", "_ns_", "_ws_",
                                      "instance", "job"], "label_names")
    need(len(results['label_values("_ns_")']) == n_ns, "label_values(_ns_)")
    n_inst = len(results['label_values("instance")'])
    need(n_inst == args.series, "label_values(instance)")
    need(len(results['series({_ns_="App-0"})']) == n_app0, "series")
    log(f"  answers: absent, count_values (its counts summing to count()), "
        f"sort_desc's order, label_replace, limit, time(), scalar, vector, "
        f"@ (equal to the range query's column at the end, rtol 1e-6), the "
        f"subquery (equal to the float64 max over its inner matrix, rtol "
        f"1e-12), the instant queries and the metadata ({n_inst} "
        f"instances) checked")
    _build.LAUNCHES.update(launches)  # the checks' launches are not counted
    seconds = time.perf_counter() - t_phase
    log(f"  phase 9 took {seconds:.1f} s")
    return {"queries": timings, "sidecar": sidecar, "launches": launches,
            "peak_bytes": int(peak), "seconds": seconds}


def _valved(call, env: dict, *a):
    with valves(**env):
        return call(*a)


def sidecar_instants(svc, end: int) -> list:
    """``SIDECAR_INSTANT`` at ``end`` under each of ``SIDECAR_VALVES``:
    cold, warm p50 of 3, the engine, the lane's served and bypassed
    counts and B1/B2 launches; the lane's answers held against the decode
    lane's within the reference's sidecar tolerance (rtol 2e-5, atol
    1e-9)."""
    from filodb_tpu_torch import _build
    from filodb_tpu_torch.query.engine import sidecar_lane as sl

    out = []
    for q in SIDECAR_INSTANT:
        answers = {}
        for name, env in SIDECAR_VALVES:
            served, bypassed = sl.SIDECAR_SERVED.value, \
                sl.SIDECAR_BYPASSED.value
            l0 = dict(_build.LAUNCHES)
            with valves(**env):
                t = time.perf_counter()
                r = svc.query_instant(q, end)
                r.result.materialize()
                cold = (time.perf_counter() - t) * 1000.0
                warm = []
                # the default gate once: its decision, not its time
                for _ in range(0 if name == "default gate" else 3):
                    t = time.perf_counter()
                    r = svc.query_instant(q, end)
                    r.result.materialize()
                    warm.append((time.perf_counter() - t) * 1000.0)
            rec = {"query": q, "valve": name, "cold_ms": cold,
                   "warm_p50_ms": float(np.median(warm)) if warm else None,
                   "engine": r.stats.engine,
                   "served": sl.SIDECAR_SERVED.value - served,
                   "bypassed": sl.SIDECAR_BYPASSED.value - bypassed,
                   "b1_b2": [_build.LAUNCHES[k] - l0[k] for k in
                             ("decode_ts_page", "decode_f32_page")]}
            out.append(rec)
            answers[name] = _sorted_answer(r)
            log(f"  instant {q} [{name}]: cold {cold:.1f} ms, warm p50 "
                f"{rec['warm_p50_ms']} ms, {rec['engine']}, sidecar "
                f"served {rec['served']} / bypassed {rec['bypassed']} "
                f"leaves, B1/B2 {rec['b1_b2']}")
        lane, dec = answers["lane"], answers["decode lane"]
        if out[-3]["served"] == 0 or out[-3]["engine"] != "exec" \
                or out[-1]["engine"] != "mesh":
            raise AssertionError(f"phase 9: {q} was not sidecar-served "
                                 f"with the lane forced: {out[-3:]}")
        if lane[0] != dec[0] or not np.allclose(
                lane[1], dec[1], rtol=2e-5, atol=1e-9, equal_nan=True):
            raise AssertionError(f"phase 9: {q}: the sidecar lane's answer "
                                 f"disagrees with the decode lane's")
    log("  sidecar-served instant queries (mesh -> exec -> the lane) agree "
        "with the decode lane within rtol 2e-5, atol 1e-9")
    return out


# phase 8: first-class histograms. Bucket bounds: Prometheus client_golang's
# DefBuckets (seconds) and +Inf; per-scrape observations a bucket are drawn
# uniformly from 0 to ``_OBS_HIGH``, a latency distribution peaking at
# 100-250 ms.
DEF_BUCKETS = np.array([0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                        5.0, 10.0, np.inf])
_OBS_HIGH = np.array([1, 1, 2, 3, 5, 8, 5, 3, 2, 1, 1, 1])
H = "http_req_latency"
HIST_QUERIES = (
    f"histogram_quantile(0.99, sum(rate({H}[5m])) by (_ns_))",
    f'histogram_quantile(0.9, rate({H}{{_ns_="App-0"}}[5m]))',
    f"sum(rate({H}[5m])) by (job)",
    f"histogram_quantile(0.5, sum(increase({H}[10m])) by (job))",
)
# the flat form: the series of App-0..App-9 again as prom-counter bucket
# series with an ``le`` label, and the native query over the same ones
FLAT_QUERY = (f"histogram_quantile(0.99, sum(rate({H}_bucket"
              f'{{_ns_=~"App-[0-9]"}}[5m])) by (le, _ns_))')
FLAT_NATIVE = (f'histogram_quantile(0.99, sum(rate({H}{{_ns_=~"App-[0-9]"}}'
               f"[5m])) by (_ns_))")
# the shapes only the exec engine answers (phase 8, through the default
# engine): the mean latency a dashboard charts from a histogram's sum and
# count columns, timestamp() of a histogram, a join of two histograms
HIST_EXEC_QUERIES = (
    f"sum(rate({H}::sum[5m])) by (_ns_) / sum(rate({H}::count[5m])) "
    f"by (_ns_)",
    f'timestamp({H}{{_ns_="App-0"}})',
    f'rate({H}{{_ns_="App-0"}}[5m]) / on (instance) '
    f'rate({H}{{_ns_="App-0"}}[5m] offset 5m)',
)
# a latency a bucket's observations stand for: its middle, 15 s past 10 s
_BUCKET_MIDS = np.array([0.0025, 0.0075, 0.0175, 0.0375, 0.075, 0.175,
                         0.375, 0.75, 1.75, 3.75, 7.5, 15.0])
_HIST_BLOCK = 10_000  # series generated and ingested at once
HIST_WARM = 7  # warm runs of each phase-8 query


def make_hist_series(rng, a: int, b: int, samples: int):
    """Histogram series a..b-1: labels, jittered timestamps, cumulative
    bucket counts int64 [n, samples, 12] with a reset of every bucket in
    about 5 % of series, and the cumulative sum (each observation counted
    at its bucket's middle) and count float64 [n, samples], reset with
    the buckets."""
    n = b - a
    labels = [{"_metric_": H, "_ws_": "demo", "_ns_": f"App-{i % 100}",
               "instance": f"instance-{i}", "job": f"job-{i % 10}"}
              for i in range(a, b)]
    ts = (T0_MS + np.arange(samples, dtype=np.int64)[None, :] * 10_000
          + rng.integers(-500, 501, (n, samples)))
    obs = rng.integers(0, _OBS_HIGH + 1, (n, samples, len(_OBS_HIGH)),
                       dtype=np.int32)
    counts = np.cumsum(np.cumsum(obs, axis=2, dtype=np.int64), axis=1)
    sums = np.cumsum(obs @ _BUCKET_MIDS, axis=1)
    reset = np.flatnonzero(rng.random(n) < 0.05)
    at = rng.integers(1, samples, len(reset))
    for r, k in zip(reset, at):
        counts[r, k:] -= counts[r, k]
        sums[r, k:] -= sums[r, k]
    return labels, ts, counts, sums, counts[:, :, -1].astype(np.float64)


def _fmt_le(le: float) -> str:
    return "+Inf" if np.isinf(le) else repr(float(le))


def hist_leaf(eng, q: str, start: int, end: int):
    """(lowered leaf, aggregation or None) of a query of the form
    [histogram_quantile(φ,] [agg(] range_fn(selector[w]) [)] [)]."""
    from filodb_tpu_torch.parallel.mesh_engine import lower_plan
    from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query
    from filodb_tpu_torch.query import logical as lp

    plan = parse_query(q, TimeStepParams(start, 60, end))
    if isinstance(plan, lp.ApplyInstantFunction):
        plan = plan.vector
    if isinstance(plan, lp.Aggregate):
        return lower_plan(plan.vector), eng._aggregation(plan)
    return lower_plan(plan), None


def hist_against_plain(svc, q: str, start: int, end: int, got) -> dict:
    """Query ``q`` (histogram_quantile over a per-bucket aggregation of one
    rate leaf) against the plain path, chunk by chunk as the engine cuts
    its batch: B1 must equal its plain version bit for bit on the timestamp
    blocks and on the bucket blocks of every chunk, and the answer must
    equal plain decode + float64 ``range_eval_masked`` per bucket, the
    per-bucket sum and the plain quantile."""
    import torch

    from filodb_tpu_torch.device import EXACT_DTYPE
    from filodb_tpu_torch.memory import device_pages as dp
    from filodb_tpu_torch.query.exec.transformers import decode_rows
    from filodb_tpu_torch.query.engine.aggregations import (
        aggregate,
        histogram_quantile,
    )
    from filodb_tpu_torch.query.engine.device_batch import (
        BLOCK,
        assemble_hist,
    )
    from filodb_tpu_torch.query.engine.kernels import range_eval_masked

    eng = svc.mesh
    low, amr = hist_leaf(eng, q, start, end)
    batch = eng._batch(svc.memstore, low)
    n, B = len(batch.keys), len(batch.les)
    NB = batch.packed[0].shape[1]
    rows = min(max(1, decode_rows(NB * BLOCK, low.fn) // B), n)
    lo_ms, hi_ms = low.chunk_range
    steps = leaf_steps(low).to(svc.device)
    outs = []
    for a in range(0, n, rows):
        part = tuple(t[a : min(a + rows, n)] for t in batch.packed)
        for name, (sl, w, wd) in (("timestamp", part[1:4]),
                                  ("bucket", part[5:8])):
            args = (sl.reshape(-1), w.reshape(-1), wd.reshape(-1, BLOCK))
            if not compare(dp.decode_ts_blocks(*args),
                           dp.decode_ts_blocks_plain(*args), 0, 0,
                           bitwise=True)[1]:
                raise AssertionError(f"B1 differs from its plain version on "
                                     f"the {name} blocks of rows {a}.. of "
                                     f"{q}")
        ts, counts, valid = assemble_hist(part, hi_ms - lo_ms, plain=True)
        outs.append(range_eval_masked(low.fn, ts, counts, valid, steps,
                                      low.window, counter=True,
                                      dtype=EXACT_DTYPE))
    per_series = torch.cat(outs)                             # [n, B, K]
    K = per_series.shape[2]
    gids, gkeys = keys_group_ids(eng, amr, batch.out_keys)
    G = len(gkeys)
    gb = (gids[:, None] * B + torch.arange(B, device=gids.device)).reshape(-1)
    summed = aggregate("sum", per_series.reshape(n * B, K), gb, G * B)
    phi = float(q.split("(")[1].split(",")[0])
    want = histogram_quantile(phi, summed.view(G, B, K).transpose(1, 2),
                              torch.from_numpy(batch.les)).cpu().numpy()
    order = {str(k): i for i, k in enumerate(gkeys)}
    idx = [order[str(k)] for k in got.keys]
    if got.values.shape != want.shape or not np.allclose(
            got.values, want[idx], rtol=1e-9, atol=0, equal_nan=True):
        raise AssertionError(f"{q} disagrees with the plain path")
    chunks = -(-n // rows)
    return {"series": n, "buckets": B, "rows": rows, "chunks": chunks,
            "last_rows": n - (chunks - 1) * rows}


def hist_split(svc, q: str, start: int, end: int, rows: int,
               reps: int) -> dict:
    """Times of each part of one engine-sized chunk of the histogram rate
    leaf of ``q`` (``split_times``: CUDA events, median of 5 rounds, and
    profiler device time): B1 on the timestamp blocks, B1 on the bucket
    blocks, the glue (gap fill, range mask, int64 base add in float64), the
    per-bucket float64 rate, the per-bucket sum of the chunk's rows and the
    quantile; and the whole chunk (decode to rate)."""
    import torch

    from filodb_tpu_torch.device import EXACT_DTYPE
    from filodb_tpu_torch.memory import device_pages as dp
    from filodb_tpu_torch.query.engine.aggregations import (
        aggregate,
        histogram_quantile,
    )
    from filodb_tpu_torch.query.engine.device_batch import BLOCK, fill_hist
    from filodb_tpu_torch.query.engine.kernels import range_eval_masked

    eng = svc.mesh
    low, amr = hist_leaf(eng, q, start, end)
    batch = eng._batch(svc.memstore, low)
    part = tuple(t[:rows] for t in batch.packed)
    B = len(batch.les)
    lo_ms, hi_ms = low.chunk_range
    steps = leaf_steps(low).to(svc.device)
    les = torch.from_numpy(batch.les)

    def b1_ts():
        return dp.decode_ts_blocks(part[1].reshape(-1), part[2].reshape(-1),
                                   part[3].reshape(-1, BLOCK))

    def b1_buckets():
        return dp.decode_ts_blocks(part[5].reshape(-1), part[6].reshape(-1),
                                   part[7].reshape(-1, BLOCK))

    def glue(ts_off, b_off):
        return fill_hist(part[0], part[8], part[4], ts_off, b_off,
                         hi_ms - lo_ms)

    def rate(ts, counts, valid):
        return range_eval_masked(low.fn, ts, counts, valid, steps,
                                 low.window, counter=True, dtype=EXACT_DTYPE)

    gids, gkeys = keys_group_ids(eng, amr, batch.out_keys)
    G, K = len(gkeys), steps.numel()
    gb = (gids[:rows, None] * B
          + torch.arange(B, device=gids.device)).reshape(-1)

    def agg(per):
        return aggregate("sum", per.reshape(rows * B, K), gb, G * B) \
            .view(G, B, K).transpose(1, 2)

    ts_off, b_off = b1_ts(), b1_buckets()
    decoded = glue(ts_off, b_off)
    per = rate(*decoded)
    summed = agg(per)
    phi = float(q.split("(")[1].split(",")[0])
    parts = {"B1_timestamps": b1_ts, "B1_buckets": b1_buckets,
             "glue": lambda: glue(ts_off, b_off),
             "rate": lambda: rate(*decoded), "aggregation": lambda: agg(per),
             "quantile": lambda: histogram_quantile(phi, summed, les),
             "chunk": lambda: rate(*glue(b1_ts(), b1_buckets()))}
    out = split_times(parts, reps, rounds=5)
    for kind in ("events_ms", "device_ms"):
        if all(out[k][kind] is not None for k in parts):
            out[f"sum_of_parts_{kind}"] = sum(out[k][kind] for k in parts
                                              if k != "chunk")
    out["rows"], out["buckets"], out["S"] = rows, B, int(decoded[0].shape[1])
    return out


def b1_bucket_case(svc, q: str, start: int, end: int, rows: int,
                   reps: int) -> dict:
    """B1 on the bucket blocks of one engine-sized chunk: time, plain
    time, and its byte bound at that shape (per-block slope and width, the
    4·w words each width needs, the int32 output)."""
    from filodb_tpu_torch.memory import device_pages as dp
    from filodb_tpu_torch.query.engine.device_batch import BLOCK

    batch = svc.mesh._batch(svc.memstore, hist_leaf(svc.mesh, q, start,
                                                      end)[0])
    part = tuple(t[:rows] for t in batch.packed)
    args = (part[5].reshape(-1), part[6].reshape(-1),
            part[7].reshape(-1, BLOCK))
    nb = args[1].numel()
    nbytes = nb * (8 + 512) + word_bytes(args[1])
    b, by = bound_ms(nbytes, nb * B1_OPS_BLOCK)
    return {"blocks": nb, "ms": cuda_time_ms(lambda: dp.decode_ts_blocks(
        *args), reps), "plain_ms": wall_ms(lambda: dp.decode_ts_blocks_plain(
            *args)), "bound_ms": b, "bound_by": by, "bound_bytes": nbytes}


def selector_batch(svc, sel: str, start: int, end: int, window_ms: int,
                   offset_ms: int = 0):
    """(the batch of selector ``sel`` over every shard, built as the mesh
    engine builds it, rows in shard order as the exec leaves concatenate
    them; the query's steps relative to its start) for a window of
    ``window_ms`` at ``offset_ms``."""
    import torch

    from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query
    from filodb_tpu_torch.query.engine.device_batch import build_device_batch

    raw = parse_query(sel, TimeStepParams(start, 60, end)).raw
    lo = start * 1000 - window_ms - offset_ms
    hi = end * 1000 - offset_ms
    batch = build_device_batch(
        [(sh, sh.lookup_partitions(list(raw.filters), lo, hi))
         for sh in svc.memstore.shards], lo, hi, svc.device, raw.column)
    steps = np.arange(start * 1000, end * 1000 + 1, 60_000) - offset_ms - lo
    return batch, torch.from_numpy(steps.astype(np.int32)).to(svc.device)


def _aligned(got, keys, want, what: str, rtol: float | None = None):
    """``got``'s rows against ``want`` [len(keys), ...] by key: bit for bit,
    or within ``rtol``."""
    order = {str(k): i for i, k in enumerate(keys)}
    if sorted(order) != sorted(str(k) for k in got.keys):
        raise AssertionError(f"{what}: the series differ from the plain "
                             f"path's")
    w = want[[order[str(k)] for k in got.keys]]
    ok = got.values.shape == w.shape and (
        np.array_equal(got.values, w, equal_nan=True) if rtol is None
        else np.allclose(got.values, w, rtol=rtol, atol=0, equal_nan=True))
    if not ok:
        raise AssertionError(f"{what}: disagrees with the plain path on the "
                             f"card")


def mean_latency_plain(svc, start: int, end: int, got) -> dict:
    """The mean-latency query against B3's plain version over the ``sum``
    and ``count`` value pages of every series, or where a column's values
    are not exact in float32 (the sums: observations at the buckets'
    middles) the float64 rate over its host-decode lane batch, summed by
    namespace and divided (rtol 1e-9: the card's sums add in another
    order)."""
    from filodb_tpu_torch.query.engine.aggregations import aggregate
    from filodb_tpu_torch.query.engine.batch import SeriesBatch
    from filodb_tpu_torch.query.engine.kernels import range_eval
    from filodb_tpu_torch.query.exec.transformers import (
        F32_SAFE_MAX,
        AggregateMapReduce,
    )

    amr = AggregateMapReduce("sum", by=("_ns_",))
    sums, lanes = {}, {}
    for col in ("sum", "count"):
        batch, steps = selector_batch(svc, f"{H}::{col}", start, end, 300_000)
        n = len(batch.keys)
        if isinstance(batch, SeriesBatch):
            ts, vals, counts, raw = batch.delta_arrays(True)
            rates = range_eval("rate", ts, vals, counts, steps, 300_000,
                               pre_corrected=True, raw=raw)
            lanes[col] = "host"
        else:
            rates = plain_b3(batch.packed, steps, 300_000, "rate")[:n]
            lanes[col] = "B3" if batch.vmax < F32_SAFE_MAX else "precise"
        gids, gkeys = keys_group_ids(svc.mesh, amr, batch.out_keys)
        sums[col] = (aggregate("sum", rates.double(), gids, len(gkeys)),
                     gkeys)
    (num, keys), (den, _) = sums["sum"], sums["count"]
    _aligned(got, keys, (num / den).cpu().numpy(), "mean latency", 1e-9)
    return {"lane_sum": lanes["sum"], "lane_count": lanes["count"],
            "check": "B3 plain or the host lane's float64 rate, rtol 1e-9"}


def _hist_plain(svc, sel: str, fn: str, start: int, end: int,
                offset_ms: int = 0):
    """A histogram leaf [n, K, B] by B1's plain version and the float64
    per-bucket function; and the batch's metric-free keys."""
    from filodb_tpu_torch.device import EXACT_DTYPE
    from filodb_tpu_torch.query.engine.device_batch import assemble_hist
    from filodb_tpu_torch.query.engine.kernels import range_eval_masked

    batch, steps = selector_batch(svc, sel, start, end, 300_000, offset_ms)
    ts, counts, valid = assemble_hist(batch.packed, batch.end - batch.base,
                                      plain=True)
    out = range_eval_masked(fn, ts, counts, valid, steps, 300_000,
                            counter=True, dtype=EXACT_DTYPE)
    return out[: len(batch.keys)].transpose(1, 2), batch.out_keys


def timestamp_plain(svc, start: int, end: int, got) -> dict:
    """timestamp(h) against B1's plain version and the float64 function,
    bit for bit: seconds from the batch start, as the reference's exec
    engine answers it."""
    want, keys = _hist_plain(svc, f'{H}{{_ns_="App-0"}}', "timestamp", start,
                             end)
    _aligned(got, keys, want.cpu().numpy(), "timestamp(h)")
    return {"check": "B1 plain + float64 timestamp, bitwise",
            "max_s": float(np.nanmax(got.values))}


def hist_join_plain(svc, start: int, end: int, got) -> dict:
    """The join of two histogram rates against B1's plain version and the
    float64 per-bucket rate of each side, matched by instance (rtol
    1e-12)."""
    sel = f'{H}{{_ns_="App-0"}}'
    now, keys = _hist_plain(svc, sel, "rate", start, end)
    before, keys_b = _hist_plain(svc, sel, "rate", start, end, 300_000)
    if [k.only(("instance",)) for k in keys] \
            != [k.only(("instance",)) for k in keys_b]:
        raise AssertionError("histogram join: the sides' series differ")
    _aligned(got, [k.only(("instance",)) for k in keys],
             (now / before).cpu().numpy(), "histogram join", 1e-12)
    return {"check": "B1 plain + float64 rate per bucket, rtol 1e-12"}


def hist_exec_queries(svc, start: int, end: int, reps: int = 5) -> list:
    """Phase 8's shapes that only the exec engine answers, through the
    default engine: each must be handed to exec and agree with the plain
    path on the card; cold and warm times and launches are printed."""
    from filodb_tpu_torch import _build

    checks = (mean_latency_plain, timestamp_plain, hist_join_plain)
    out = []
    for q, check in zip(HIST_EXEC_QUERIES, checks):
        _build.reset_counts()
        t = time.perf_counter()
        r = svc.query_range(q, start, 60, end)
        cold = (time.perf_counter() - t) * 1000.0
        warm = []
        for _ in range(reps):
            t = time.perf_counter()
            r = svc.query_range(q, start, 60, end)
            warm.append((time.perf_counter() - t) * 1000.0)
        launches = dict(_build.LAUNCHES)
        if r.stats.engine != "exec":
            raise AssertionError(f"{q}: served by {r.stats.engine}, not by "
                                 f"the exec engine")
        checked = check(svc, start, end, r.result)
        rec = dict(query=q, cold_ms=cold, warm_p50_ms=float(np.median(warm)),
                   rows=r.result.num_series, launches=launches,
                   fallback=r.stats.fallback, **checked)
        if q == HIST_EXEC_QUERIES[0] and "B3" in (rec["lane_sum"],
                                                  rec["lane_count"]) \
                and svc.device.type == "cuda" \
                and not launches["fused_decode_rate"]:
            raise AssertionError(f"{q}: B3 did not serve the count column")
        out.append(rec)
        log(f"  exec (handed on by mesh: {r.stats.fallback}) {q}: cold "
            f"{cold:.1f} ms, warm p50 {np.median(warm):.2f} ms, "
            f"{r.result.num_series} rows, launches {launches}, {checked}")
    return out


def histogram_phase(dev, args, reps: int) -> dict:
    """Phase 8: first-class histograms at full width, and the flat form."""
    import torch

    from filodb_tpu_torch import _build
    from filodb_tpu_torch.core.memstore.memstore import MemStore
    from filodb_tpu_torch.http.promjson import matrix_json

    t_phase = t = time.perf_counter()
    N, samples = args.hist_series, args.samples
    store = MemStore(num_shards=4, spread=1, max_chunk_size=400)
    kept, flat_parts = 0, []
    for a in range(0, N, _HIST_BLOCK):
        rng = np.random.default_rng([args.seed, 8, a])
        labels, ts, counts, sums, cnts = make_hist_series(
            rng, a, min(a + _HIST_BLOCK, N), samples)
        kept += store.ingest_histograms(labels, ts, counts, DEF_BUCKETS,
                                        sums=sums, counts=cnts)
        sel = [j for j, lb in enumerate(labels) if int(lb["_ns_"][4:]) < 10]
        flat_parts.append(([labels[j] for j in sel], ts[sel], counts[sel]))
    ingest_s = time.perf_counter() - t
    chunks = sum(len(s.hist_chunks["pid"]) for s in store.shards)
    log(f"phase 8: histograms: {N} series x {samples} samples x "
        f"{len(DEF_BUCKETS)} buckets ({kept} samples, {chunks} sealed "
        f"chunks), ingest {ingest_s:.1f} s on the host")
    # the flat form on a second store: App-0..App-9 as le-labelled counters
    t = time.perf_counter()
    flat_store = MemStore(num_shards=4, spread=1, max_chunk_size=400)
    lbs = [{**lb, "_metric_": f"{H}_bucket", "le": _fmt_le(le)}
           for part in flat_parts for lb in part[0] for le in DEF_BUCKETS]
    fts = np.concatenate([np.repeat(p[1], len(DEF_BUCKETS), axis=0)
                          for p in flat_parts])
    fvals = np.concatenate([p[2].transpose(0, 2, 1).reshape(-1, samples)
                            for p in flat_parts]).astype(np.float64)
    del flat_parts
    flat_store.ingest_series(lbs, fts, fvals)
    flat_s = time.perf_counter() - t
    log(f"  flat form: {len(lbs)} prom-counter series {H}_bucket{{le=...}} "
        f"of App-0..App-9, ingest {flat_s:.1f} s on the host")

    svc = smoke_service(store, device=dev)
    flat_svc = smoke_service(flat_store, device=dev)
    start, end = T0_MS // 1000, T0_MS // 1000 + 7200
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    results, timings = {}, []
    for s, q in [(svc, q) for q in HIST_QUERIES] \
            + [(flat_svc, FLAT_QUERY), (svc, FLAT_NATIVE)]:
        t = time.perf_counter()
        r = on_mesh(s.query_range(q, start, 60, end), q)
        cold = (time.perf_counter() - t) * 1000.0
        warm = []
        for _ in range(HIST_WARM):
            t = time.perf_counter()
            r = s.query_range(q, start, 60, end)
            warm.append((time.perf_counter() - t) * 1000.0)
        results[q] = r
        timings.append(dict(query=q, cold_ms=cold,
                            warm_p50_ms=float(np.median(warm)),
                            warm_ms=warm, rows=r.result.num_series))
        log(f"  {q}: cold {cold:.1f} ms, warm p50 {np.median(warm):.2f} "
            f"ms (min {min(warm):.2f}, max {max(warm):.2f} of {HIST_WARM}), "
            f"{r.result.num_series} rows")
    launches = dict(_build.LAUNCHES)
    packed = svc.mesh.batch_bytes
    log(f"  launches in the phase: {launches}; packed pages on the card "
        f"{packed / 1e9:.2f} GB (histograms) and "
        f"{flat_svc.mesh.batch_bytes / 1e9:.2f} GB (the flat form)")
    if dev.type == "cuda" and not (launches["decode_ts_page"]
                                   and launches["fused_decode_rate"]):
        raise AssertionError("phase 8 did not run through B1 (histograms) "
                             "and B3 (the flat form)")

    # answers: shapes, finite values after the first step, Prom JSON, the
    # flat form against the native one
    qa, qb, qc, qd = HIST_QUERIES
    n_ns, n_job = min(100, N), min(10, N)
    app0 = len(range(0, N, 100))
    for q, shape in ((qa, (n_ns, 121)), (qb, (app0, 121)),
                     (qc, (n_job, 121, 12)), (qd, (n_job, 121))):
        v = results[q].result.values
        if v.shape != shape or not np.isfinite(v[:, 1:]).all():
            raise AssertionError(f"{q}: shape {v.shape}, want {shape}, "
                                 f"finite after the first step")
    body = matrix_json(results[qc])
    les = {s["metric"]["le"] for s in body["data"]["result"]}
    if len(body["data"]["result"]) != n_job * 12 \
            or les != {_fmt_le(x) for x in DEF_BUCKETS}:
        raise AssertionError("sum(rate) by (job): bad Prometheus body")
    fr, nr = results[FLAT_QUERY].result, results[FLAT_NATIVE].result
    fk = {str(k): i for i, k in enumerate(fr.keys)}
    if sorted(fk) != sorted(str(k) for k in nr.keys) or not np.allclose(
            fr.values[[fk[str(k)] for k in nr.keys]], nr.values, rtol=1e-5,
            atol=0, equal_nan=True):
        raise AssertionError("the le form disagrees with the native form")
    plain = hist_against_plain(svc, qa, start, end, results[qa].result)
    log(f"  answers: shapes and finite values checked; {qc} renders "
        f"{n_job} x 12 le series; the le form equals the native form at "
        f"rtol 1e-5 over {len(nr.keys)} namespaces. {qa}: B1 bitwise equal "
        f"to plain on the timestamp and bucket blocks of {plain['chunks']} "
        f"chunks of {plain['rows']} series x 12 buckets (last "
        f"{plain['last_rows']}); answer equal to plain decode + float64 "
        f"rate + sum + quantile (rtol 1e-9)")
    split = hist_split(svc, qa, start, end, plain["rows"], reps)
    log(f"  {qa} chunk split at the engine's rows (ms: CUDA events, median "
        f"of 5 rounds, and profiler device time): {json.dumps(split)}")
    b1 = b1_bucket_case(svc, qa, start, end, plain["rows"], reps)
    log(f"  B1 on one chunk's bucket blocks: {json.dumps(b1)}")
    peak = torch.cuda.max_memory_allocated()
    log(f"  peak device memory {peak / 1e9:.2f} GB (max_memory_allocated)")
    exec_runs = hist_exec_queries(svc, start, end)
    _build.LAUNCHES.update(launches)  # the checks' launches are not counted
    seconds = time.perf_counter() - t_phase
    log(f"  phase 8 took {seconds:.1f} s")
    return {"series": N, "buckets": len(DEF_BUCKETS), "samples": samples,
            "ingest_s": ingest_s, "flat_series": len(lbs),
            "flat_ingest_s": flat_s, "packed_bytes": int(packed),
            "queries": timings, "launches": launches, "plain_check": plain,
            "split": split, "b1_buckets": b1, "peak_bytes": int(peak),
            "exec_queries": exec_runs, "seconds": seconds}


def exec_phase(svc, args) -> dict:
    """Phase 10: ``QueryService(engine="exec")`` at full width on the
    phase-2 store: each of ``EXEC_QUERIES`` cold once and warm
    ``EXEC_WARM`` times, its plan tree's leaf count and its launches (B3
    once a leaf and run for the rates; B1, B2 and B4 in every leaf for
    count_over_time), held against the mesh engine's answer in the same run
    (per series bit for bit, aggregated within rtol 1e-9: the sums add in
    another order) with the mesh engine's times beside (its first call may
    find its batch cached by phases 3-5; phase 3 gives its cold time)."""
    import torch

    from filodb_tpu_torch import _build
    from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query
    from filodb_tpu_torch.query.exec.plan import leaves

    t_phase = time.perf_counter()
    start, end = T0_MS // 1000, END_S
    ex = smoke_service(svc.memstore, device=svc.device, engine="exec")
    log("phase 10: the exec engine (QueryService(engine=\"exec\"), a leaf "
        "a shard) on the phase-2 store, against the mesh engine:")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    total = {k: 0 for k in _build.LAUNCHES}
    out = []

    def timed(s, q):
        t = time.perf_counter()
        r = s.query_range(q, start, 60, end)
        first = (time.perf_counter() - t) * 1000.0
        warm = []
        for _ in range(EXEC_WARM):
            t = time.perf_counter()
            r = s.query_range(q, start, 60, end)
            warm.append((time.perf_counter() - t) * 1000.0)
        return r, first, float(np.median(warm))

    for q in EXEC_QUERIES:
        tree = ex.planner.materialize(parse_query(q, TimeStepParams(
            start, 60, end)))
        n_leaves = len(leaves(tree))
        # leaves whose shard holds a matching series: the others launch
        # nothing
        n_data = sum(bool(len(svc.memstore.shards[f.shard].lookup_partitions(
            list(f.filters), f.chunk_start, f.chunk_end)))
            for f in leaves(tree))
        _build.reset_counts()
        r, cold, p50 = timed(ex, q)
        launches = dict(_build.LAUNCHES)
        for k, v in launches.items():
            total[k] += v
        m, m_first, m_p50 = timed(svc, q)
        if (r.stats.engine, m.stats.engine) != ("exec", "mesh"):
            raise AssertionError(f"{q}: engines {r.stats.engine}, "
                                 f"{m.stats.engine}")
        runs = 1 + EXEC_WARM
        if svc.device.type == "cuda":
            if "rate(" in q and launches["fused_decode_rate"] \
                    != runs * n_data:
                raise AssertionError(f"{q}: B3 launched "
                                     f"{launches['fused_decode_rate']} times "
                                     f"for {n_data} leaves with series x "
                                     f"{runs} runs")
            if "count_over_time" in q and min(
                    launches["decode_ts_page"], launches["decode_f32_page"],
                    launches["windowed_sum"]) < runs * n_data:
                raise AssertionError(f"{q}: B1, B2 and B4 not in every leaf")
        if "_ws_" in q and n_leaves != 2:
            raise AssertionError(f"{q}: {n_leaves} leaves, not the 2 shards "
                                 f"of its shard key")
        per_series = not q.startswith("sum")
        _aligned(r.result, m.result.keys, m.result.values, f"phase 10 {q}",
                 None if per_series else 1e-9)
        rec = dict(query=q, leaves=n_leaves, leaves_with_series=n_data,
                   launches=launches,
                   cold_ms=cold, warm_p50_ms=p50, mesh_first_ms=m_first,
                   mesh_warm_p50_ms=m_p50, rows=r.result.num_series,
                   check="bitwise" if per_series else "rtol 1e-9")
        out.append(rec)
        log(f"  {q}: {n_leaves} leaves ({n_data} with series); exec cold {cold:.1f} ms, warm p50 "
            f"{p50:.2f} ms; mesh first {m_first:.1f} ms, warm p50 "
            f"{m_p50:.2f} ms; {r.result.num_series} rows, equal to mesh "
            f"({rec['check']}); launches {launches}")
    q0 = EXEC_QUERIES[0]
    prof_svcs = (("exec", ex), ("mesh", svc))
    prof = {name: top_device_ops(
        lambda s=s: s.query_range(q0, start, 60, end), EXEC_WARM)
        for name, s in prof_svcs}
    for name, rec in prof.items():
        wall = next(r[f"{'' if name == 'exec' else 'mesh_'}warm_p50_ms"]
                    for r in out if r["query"] == q0)
        rec["idle_share"] = 1.0 - rec["device_ms"] / wall
        if not 0.0 <= rec["idle_share"] < 1.0:
            raise AssertionError(f"{q0} on {name}: device time "
                                 f"{rec['device_ms']:.3f} ms a query against "
                                 f"a warm p50 of {wall:.3f} ms")
        rec["host_self_ms"] = host_split(
            lambda s=dict(prof_svcs)[name]: s.query_range(q0, start, 60, end),
            EXEC_WARM)
        log(f"  {q0} on {name}, torch.profiler device time a warm query "
            f"{rec['device_ms']:.2f} ms (idle share of its warm p50 "
            f"{rec['idle_share']:.2f}); largest: {json.dumps(rec['top_ms'])}"
            f"; host self ms (cProfile): {json.dumps(rec['host_self_ms'])}")
    peak = torch.cuda.max_memory_allocated()
    log(f"  exec batches on the card {ex.batches.nbytes('exec') / 1e9:.2f} GB, "
        f"mesh batches {svc.mesh.batch_bytes / 1e9:.2f} GB; peak device "
        f"memory {peak / 1e9:.2f} GB (max_memory_allocated)")
    seconds = time.perf_counter() - t_phase
    log(f"  phase 10 took {seconds:.1f} s")
    return {"queries": out, "launches": total, "profile": prof,
            "peak_bytes": int(peak),
            "exec_batch_bytes": int(ex.batches.nbytes("exec")),
            "seconds": seconds}


# phase 11: durability. The phase-2 store (built on a local-disk column and
# meta store) flushes, takes one more scrape through the write-ahead log,
# flushes half of its groups and is dropped; a new store on the same
# directory and logs recovers its index, replays the log and must answer
# these queries bitwise as the live store did, paging every chunk in from
# disk (B1-B4 on data read back).
DURABLE_QUERIES = (f"sum(rate({M}[5m])) by (_ns_)",
                   f"sum(count_over_time({M}[5m])) by (job)")
# series of phase 11's store: the first of the phase-2 generator's. On an
# H100's host this phase takes 70-90 s a 100,000 series (flush, scrape,
# index, replay, two cold page-ins; 295-371 s at 400,000 series), so the
# full million would add 12-15 minutes to the smoke; cut to 150,000 to
# keep the smoke with phase 13 well inside its limit on the card's slower
# hosts, then to 100,000 when phase 16 came: at 150,000 the whole smoke
# took 1,203 s of its 1,200 s on a host 18 % slower in phase 2's ingest
# than the run before, then to 50,000 when phase 20 came, whose node boots
# twice over the same directory (PERF.md §4)
DURABLE_SERIES = 50_000
DURABLE_HIST = f"histogram_quantile(0.99, sum(rate({H}[5m])) by (_ns_))"
DURABLE_HIST_SERIES = 10_000  # App-0..App-9, 1,000 histograms each
DURABLE_END_S = END_S + 60    # 2 h plus the new scrape, at 60 s
SCRAPE_RECORDS = 10_000       # records a container of the scrape
DURABLE_WARM = 3


def durable_store(root: str, dataset: str, **cfg):
    """A 4-shard, spread-1 store on the local-disk column and meta stores
    under ``root`` (``<root>/columnstore``, the standalone server's
    layout; 400-sample chunks, the reference's 20 groups a shard; ``cfg``
    sets other ``StoreConfig`` fields)."""
    from filodb_tpu_torch.core.memstore.memstore import MemStore
    from filodb_tpu_torch.core.store.config import StoreConfig
    from filodb_tpu_torch.core.store.localstore import (
        LocalDiskColumnStore,
        LocalDiskMetaStore,
    )

    cs = str(Path(root) / "columnstore")
    return MemStore(4, 1, column_store=LocalDiskColumnStore(cs),
                    meta_store=LocalDiskMetaStore(cs),
                    config=StoreConfig(max_chunk_size=400,
                                       groups_per_shard=20, **cfg),
                    dataset=dataset)


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def last_samples(store):
    """(keys, timestamps, values) of every series' last sample, from the
    write buffers (the 720th sample of a 400-sample-chunk series is in its
    buffer); histogram values are the [B + 2] slots (buckets, sum, count)."""
    keys, ts, vals = [], [], []
    for shard in store.shards:
        for buf in [shard.buffers, *shard.hist_buffers.values()]:
            rows = buf.occupied()
            if not len(rows):
                continue
            n = buf.n[rows].astype(np.int64)
            keys += [shard.keys[p] for p in buf.pid_of[rows].tolist()]
            ts.append(buf.ts[rows, n - 1])
            vals.append(buf.vals[rows, n - 1])
    return keys, np.concatenate(ts), np.concatenate(vals)


def scrape_through_wal(store, wal_root, keys, ts, vals, les=None):
    """One more scrape: a sample a series 10 s after its last, as record
    containers (histogram values: tag 1) routed by ``MemStore.shard_of``,
    appended to a ``SegmentedFileLog`` a shard and ingested with their
    offsets. Returns (logs, containers, records, seconds)."""
    from filodb_tpu_torch.core.record import (
        BytesContainer,
        IngestRecord,
        RecordContainer,
        SomeData,
    )
    from filodb_tpu_torch.kafka.log import SegmentedFileLog

    t = time.perf_counter()
    shard_of = store.shard_of(keys)
    logs, containers = {}, 0
    for s in range(store.num_shards):
        logs[s] = SegmentedFileLog(str(Path(wal_root) / f"shard-{s}"))
        idx = np.flatnonzero(shard_of == s).tolist()
        for a in range(0, len(idx), SCRAPE_RECORDS):
            c = RecordContainer()
            for i in idx[a:a + SCRAPE_RECORDS]:
                v = (float(vals[i]),) if les is None else (
                    float(vals[i, -2]), float(vals[i, -1]),
                    (les, vals[i, :-2].astype(np.int64)))
                c.add(IngestRecord(keys[i], int(ts[i]), v))
            raw = c.serialize()
            off = logs[s].append(BytesContainer(raw))
            store.shards[s].ingest(SomeData(BytesContainer(raw), off))
            containers += 1
    return logs, containers, len(keys), time.perf_counter() - t


def _sorted_answer(res):
    m = res.result
    m.materialize()
    keys = [str(k) for k in m.keys]
    order = np.argsort(keys)
    return [keys[i] for i in order], np.asarray(m.values)[order]


def _paging_seconds(store) -> dict:
    out = {"read": 0.0, "decode": 0.0, "encode": 0.0}
    for sh in store.shards:
        for k, v in sh.odp_cache.seconds.items():
            out[k] += v
    return out


def restart_and_check(root, dataset, wal_root, queries, live, dev,
                      engines=("mesh", "exec")):
    """A new store on ``root`` and the logs under ``wal_root``: recover the
    index, then replay each shard's log from its recovery start; then each
    of ``queries`` on each engine, cold and warm, held bitwise against the
    live store's answers ``live``."""
    import torch

    from filodb_tpu_torch.kafka.log import SegmentedFileLog

    store = durable_store(root, dataset)
    t = time.perf_counter()
    keys = sum(store.recover_index(s) for s in range(store.num_shards))
    index_s = time.perf_counter() - t
    t = time.perf_counter()
    records = 0
    for s in range(store.num_shards):
        log_ = SegmentedFileLog(str(Path(wal_root) / f"shard-{s}"))
        start = store.recovery_start_offset(s)
        for sd in log_.read_from(start):
            records += len(sd.container)
            store.shards[s].ingest(sd)
        log_.close()
    replay_s = time.perf_counter() - t
    skipped = sum(sh.rows_skipped for sh in store.shards)
    out = {"keys_restored": keys, "index_recovery_s": index_s,
           "records_replayed": records, "records_skipped": skipped,
           "replay_s": replay_s,
           "replay_records_per_s": records / max(replay_s, 1e-9),
           "queries": []}
    start, end = T0_MS // 1000, DURABLE_END_S
    for engine in engines:
        svc = smoke_service(store, device=dev, engine=engine)
        for q in queries:
            before = _paging_seconds(store)
            paged0 = sum(sh.odp_cache.chunks_paged for sh in store.shards)
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = svc.query_range(q, start, 60, end)
            got = _sorted_answer(res)
            cold = (time.perf_counter() - t) * 1000.0
            warm = []
            for _ in range(DURABLE_WARM):
                t = time.perf_counter()
                _sorted_answer(svc.query_range(q, start, 60, end))
                warm.append((time.perf_counter() - t) * 1000.0)
            want = live[(engine, q)]
            if got[0] != want[0] or got[1].tobytes() != want[1].tobytes():
                raise AssertionError(f"phase 11: {engine} {q} after the "
                                     f"restart differs from the live store")
            after = _paging_seconds(store)
            split = {k: (after[k] - before[k]) * 1000.0 for k in after}
            p50 = float(np.median(warm))
            split["pack_upload"] = cold - sum(split.values()) - p50
            split["kernels_and_rest"] = p50
            paged = sum(sh.odp_cache.chunks_paged
                        for sh in store.shards) - paged0
            out["queries"].append({
                "engine": engine, "query": q, "cold_ms": cold,
                "warm_p50_ms": p50, "rows": len(got[0]),
                "chunks_paged": paged, "cold_split_ms": split,
                "served_by": res.stats.engine})
            log(f"  {engine} {q}: cold {cold:.1f} ms (read "
                f"{split['read']:.0f}, decode {split['decode']:.0f}, page "
                f"encode {split['encode']:.0f}, pack and upload "
                f"{split['pack_upload']:.0f}; {paged} chunks paged), warm "
                f"p50 {p50:.2f} ms, {len(got[0])} rows, bitwise equal to "
                f"the live store")
        del svc
    store.close()
    return out


def live_answers(store, queries, dev, engines=("mesh", "exec")) -> dict:
    """Each query's answer on each engine, sorted by key; and under
    ("body", q) the data of the mesh engine's Prometheus body
    (``body_data``)."""
    from filodb_tpu_torch.http.promjson import matrix_json_str

    out = {}
    for engine in engines:
        svc = smoke_service(store, device=dev, engine=engine)
        for q in queries:
            res = svc.query_range(q, T0_MS // 1000, 60, DURABLE_END_S)
            if engine == "mesh":
                out[("body", q)] = body_data(matrix_json_str(res))
            out[(engine, q)] = _sorted_answer(res)
    return out


def body_data(body: str) -> str:
    """A Prometheus body without its ``queryStats`` (wall time, counters):
    the bytes two answers of the same data share."""
    cut = body.find(',"queryStats"')
    return body if cut < 0 else body[:cut] + "}"


def flush_half(store) -> int:
    return sum(sh.flush_group(g) for sh in store.shards
               for g in range(sh.config.groups_per_shard // 2))


def chunk_infos_check(svc, store) -> dict:
    """``chunk_infos`` of one series against the chunks the store wrote
    for it."""
    from filodb_tpu_torch.core.filters import ColumnFilter, Equals
    from filodb_tpu_torch.memory.chunk import Chunk

    shard = store.shards[0]
    key = shard.keys[0]
    filters = [ColumnFilter(k, Equals(v)) for k, v in key.labels]
    lo, hi = T0_MS, DURABLE_END_S * 1000
    infos = [i for i in svc.chunk_infos(filters, lo, hi)
             if i["shard"] == 0 and i["partId"] == 0]
    written = [Chunk.deserialize(d) for _, d in store.column_store
               .read_chunk_rows(store.dataset, 0, [key.serialized], lo, hi)]
    want = [(c.id, c.num_rows, c.start_time, c.end_time, c.nbytes)
            for c in written]
    got = [(i["chunkId"], i["numRows"], i["startTime"], i["endTime"],
            i["numBytes"]) for i in infos]
    if got != want or not got:
        raise AssertionError(f"chunk_infos {got} != chunks written {want}")
    log(f"  chunk_infos of {key}: {len(got)} chunks, equal to the chunks "
        f"written ({[g[1] for g in got]} rows)")
    return {"series": str(key), "chunks": len(got)}


def durability_phase(dev, args) -> dict:
    """Phase 11: a store of the phase-2 generator's first
    ``args.durable_series`` series on a local-disk column store; flush, one
    more scrape through the log, flush half the groups, ``chunk_infos``,
    drop, restart, replay, and the queries bitwise against the live
    answers; then the same for ``DURABLE_HIST_SERIES`` histograms. The
    directory stays for phase 12."""
    import gc

    import torch

    from filodb_tpu_torch import _build

    t_phase = time.perf_counter()
    root = args.durable_dir
    n_series = min(args.durable_series, args.series)
    log(f"phase 11: durability (local-disk column store under {root})")
    t = time.perf_counter()
    store = durable_store(root, "timeseries")
    ingest(store, n_series, args.samples, args.seed)
    out = {"dir": root, "series": n_series,
           "ingest_s": time.perf_counter() - t}
    log(f"  ingest: {n_series} series of the phase-2 generator, "
        f"{out['ingest_s']:.1f} s on the host")
    svc = smoke_service(store, device=dev)
    keys, ts, vals = last_samples(store)
    wal = Path(root) / "wal" / "timeseries"
    t = time.perf_counter()
    written = store.flush_all()
    flush_s = time.perf_counter() - t
    nbytes = sum(int(sh._sealed.columns["nbytes"].sum())
                 for sh in store.shards)
    samples = n_series * args.samples
    out["flush"] = {"chunks": written, "seconds": flush_s,
                    "codec_bytes": nbytes,
                    "codec_bytes_per_sample": nbytes / samples,
                    "sqlite_bytes": dir_bytes(root)}
    log(f"  flush: {written} chunks, {nbytes / samples:.3f} codec bytes a "
        f"sample, {out['flush']['sqlite_bytes'] / 1e9:.3f} GB of sqlite on "
        f"disk, {flush_s:.1f} s")
    rng = np.random.default_rng([args.seed, 11])
    ts, vals = ts + 10_000, vals + rng.integers(0, 20, len(vals))
    logs, nc, nr, scrape_s = scrape_through_wal(store, wal, keys, ts, vals)
    out["scrape"] = (keys, ts, vals)  # phase 12 scrapes after it
    for lg in logs.values():
        lg.close()
    half = flush_half(store)
    log(f"  scrape through the WAL: {nr} records in {nc} containers, "
        f"{scrape_s:.1f} s; half the groups flushed ({half} chunks)")
    live = live_answers(store, DURABLE_QUERIES, dev)
    out["chunk_infos"] = chunk_infos_check(svc, store)
    store.close()
    del svc, store, keys, ts, vals
    gc.collect()
    torch.cuda.empty_cache()

    _build.reset_counts()
    log("  restart:")
    out.update(restart_and_check(root, "timeseries", wal, DURABLE_QUERIES,
                                 live, dev))
    out["bodies"] = {q: live[("body", q)] for q in DURABLE_QUERIES}
    log(f"  restored {out['keys_restored']} keys in "
        f"{out['index_recovery_s']:.1f} s; replayed "
        f"{out['records_replayed']} records ({out['records_skipped']} below "
        f"a watermark) in {out['replay_s']:.1f} s, "
        f"{out['replay_records_per_s']:.0f} records/s")
    gc.collect()
    torch.cuda.empty_cache()
    out["histograms"] = durable_histograms(args, dev, Path(root))
    launches = dict(_build.LAUNCHES)
    out["launches"] = launches
    log(f"  launches in phase 11: {launches}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing and dev.type == "cuda":
        raise AssertionError(f"phase 11: kernels not launched: {missing}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 11 took {out['seconds']:.1f} s (its directory stays for "
        f"phase 12)")
    return out


def durable_and_node(dev, args, rules: bool = False,
                     multiproc: bool = False) -> tuple:
    """Phases 11 and 12 over one directory, with ``rules`` phase 20's
    node after phase 12's and with ``multiproc`` phase 21's after that,
    then its removal: (phase 11, phase 12, phase 20 step 2 or None, phase
    21 step 2 or None)."""
    import gc

    import torch

    durable = durability_phase(dev, args)
    gc.collect()
    torch.cuda.empty_cache()
    node = node_phase(dev, args, durable)
    del durable["scrape"], durable["bodies"]
    rules_node = mp_node = None
    if rules:
        gc.collect()
        torch.cuda.empty_cache()
        rules_node = rules_node_phase(dev, args)
    if multiproc:
        gc.collect()
        torch.cuda.empty_cache()
        mp_node = multiproc_node_phase(dev, args)
    node["bytes_freed"] = remove_dir(args.durable_dir)
    return durable, node, rules_node, mp_node


def remove_dir(root) -> int:
    """Remove phase 11's directory; returns the bytes it held."""
    freed = dir_bytes(root)
    shutil.rmtree(root)
    log(f"  removed {root}: {freed / 1e9:.3f} GB freed")
    return freed


def durable_histograms(args, dev, root: Path) -> dict:
    """Phase 11's histograms: ``DURABLE_HIST_SERIES`` series of phase 8's
    generator in App-0..App-9, ingested, flushed, one more scrape of
    histogram containers through the log, half the groups flushed, dropped,
    restarted; ``DURABLE_HIST`` bitwise against the live store."""
    import gc

    rng = np.random.default_rng([args.seed, 11, 8])
    labels, ts, counts, sums, cnts = make_hist_series(
        rng, 0, DURABLE_HIST_SERIES, args.samples)
    for i, lb in enumerate(labels):
        lb["_ns_"] = f"App-{i % 10}"
    store = durable_store(str(root), "histograms")
    t = time.perf_counter()
    store.ingest_histograms(labels, ts, counts, DEF_BUCKETS, sums=sums,
                            counts=cnts)
    ingest_s = time.perf_counter() - t
    keys, lts, slots = last_samples(store)
    t = time.perf_counter()
    written = store.flush_all()
    flush_s = time.perf_counter() - t
    obs = rng.integers(0, _OBS_HIGH + 1, (len(keys), len(_OBS_HIGH)))
    cols = slots[:, -2:].view(np.float64)
    new = np.concatenate([slots[:, :-2] + np.cumsum(obs, axis=1),
                          np.stack([cols[:, 0] + obs @ _BUCKET_MIDS,
                                    cols[:, 1] + obs.sum(1)], 1)], axis=1)
    logs, nc, nr, scrape_s = scrape_through_wal(
        store, root / "wal" / "histograms", keys, lts + 10_000, new,
        les=DEF_BUCKETS)
    for lg in logs.values():
        lg.close()
    flush_half(store)
    live = live_answers(store, [DURABLE_HIST], dev)
    store.close()
    del store
    gc.collect()
    log(f"  histograms: {len(keys)} series ingested in {ingest_s:.1f} s, "
        f"{written} chunks flushed in {flush_s:.1f} s, {nr} histogram "
        f"records through the WAL in {scrape_s:.1f} s; restart:")
    out = restart_and_check(str(root), "histograms",
                            root / "wal" / "histograms", [DURABLE_HIST],
                            live, dev)
    out.update(ingest_s=ingest_s, flush_s=flush_s, chunks=written)
    return out


NODE_DS = "timeseries"
NODE_CONCURRENCY = (8, 4)  # client threads, rounds of both queries each
NODE_WARM = 5
NODE_TICK_S = 0.5          # the flush scheduler's tick in step 5
# boot 2's first query, held byte-equal to the live node's answer (one
# namespace: its page-in is 1 % of the store's)
NODE_FIRST_QUERY = 'sum(http_requests_total{_ns_="App-0"})'
# the node's retention: the stores' samples date from T0 (2023), and the
# scheduler's tick purges past retention_ms, so the node holds ten years
NODE_RETENTION_MS = 10 * 365 * 86_400_000


def http_get(port: int, path: str, **params) -> tuple[int, str, float]:
    """(status, body, ms) of one GET on a new connection."""
    import urllib.error
    import urllib.parse
    import urllib.request

    url = f"http://127.0.0.1:{port}{path}?" + urllib.parse.urlencode(params)
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(url, timeout=900) as r:
            code, body = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read().decode()
    return code, body, (time.perf_counter() - t) * 1000.0


def node_config(root: str) -> str:
    """Phase 12's server config (written into phase 11's directory): the
    smoke's store shape, HTTP and gateway on free ports, the mesh engine,
    a flush tick of 300 s (none before step 5), snapshots every 10 s once
    the scheduler ticks, and a retention that holds the store's data."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        gateway = sock.getsockname()[1]
    path = Path(root) / "server.json"
    path.write_text(json.dumps({
        "node_name": "node-0", "data_dir": root, "http_port": 0,
        "gateway_port": gateway,
        "datasets": {NODE_DS: {
            "num_shards": 4, "spread": 1, "engine": "mesh",
            "store": {"max_chunk_size": 400, "groups_per_shard": 20,
                      "flush_interval_ms": 6_000_000,
                      "index_snapshot_interval_ms": 10_000,
                      "retention_ms": NODE_RETENTION_MS}}}}))
    return str(path)


def boot_node(path: str, dev, what: str) -> tuple:
    """A ``FiloServer`` on ``dev`` over the config at ``path``, waited on
    until every shard is ACTIVE; returns it and its boot split."""
    from filodb_tpu_torch.config import ServerConfig
    from filodb_tpu_torch.standalone import FiloServer

    t = time.perf_counter()
    srv = FiloServer(ServerConfig.load(path), device=dev).start()
    started = time.perf_counter() - t
    if not srv.cluster.wait_active(NODE_DS, timeout=900):
        raise AssertionError(f"phase 12: {what}: shards not ACTIVE: "
                             f"{srv.cluster.shard_statuses(NODE_DS)}")
    boot_s = time.perf_counter() - t
    # the dataset's shards (a node with selfmon has _meta's too)
    rec = {k: r for k, r in srv.node.recovery.items() if k[0] == NODE_DS}
    workers = [w for k, w in srv.node._workers.items() if k[0] == NODE_DS]
    shards = srv.node.memstores[NODE_DS].shards
    out = {"boot_s": boot_s, "start_s": started,
           "index_s": sum(r["index_s"] for r in rec.values()),
           "keys": sum(r["keys"] for r in rec.values()),
           "replay_s": max(w.replay_s for w in workers),
           "records_replayed": sum(w.records_replayed for w in workers),
           "records_skipped": sum(sh.rows_skipped for sh in shards),
           "from_snapshot": sum(sh.recovered_from == "snapshot"
                                for sh in shards)}
    log(f"  {what}: every shard ACTIVE {boot_s:.1f} s after start(): index "
        f"recovery {out['index_s']:.1f} s ({out['keys']} keys; "
        f"{out['from_snapshot']} of 4 shards from a snapshot), replay "
        f"{out['replay_s']:.1f} s ({out['records_replayed']} records, "
        f"{out['records_skipped']} below a watermark)")
    return srv, out


def node_phase(dev, args, durable: dict) -> dict:
    """Phase 12: the node on the card over phase 11's directory (see the
    module's phase 12)."""
    from filodb_tpu_torch import _build

    t_phase = time.perf_counter()
    root = args.durable_dir
    log("phase 12: the node on the card (FiloServer over phase 11's "
        "directory)")
    _build.reset_counts()
    # launches made in process (the in-process timings, the plain checks):
    # the phase counts only those behind the HTTP API
    side = dict.fromkeys(_build.LAUNCHES, 0)
    path = node_config(root)
    srv, boot1 = boot_node(path, dev, "boot 1 (no snapshot)")
    out = {"boot1": boot1}
    try:
        out.update(_node_queries(srv, durable, side))
        svc = srv.services[NODE_DS]
        # one answer a kernel path against the plain versions
        before = dict(_build.LAUNCHES)
        start, end = T0_MS // 1000, DURABLE_END_S
        q_rate, q_count = DURABLE_QUERIES
        with svc.lock:
            out["plain_rate"] = rate_against_plain(
                svc, q_rate, start, end, _answer(svc, q_rate))
            out["plain_decode"] = decoded_against_plain(
                svc, q_count, start, end, _answer(svc, q_count))
        for k in side:
            side[k] += _build.LAUNCHES[k] - before[k]
        log(f"  {q_rate}: B3 against its plain version "
            f"({out['plain_rate']['shape']}, max abs err "
            f"{out['plain_rate']['max_abs_err']}); {q_count}: B1/B2 bitwise "
            f"on {out['plain_decode']['chunks']} chunks, the answer equal "
            f"to plain decode")
        out["concurrency"] = _node_concurrency(srv, durable["bodies"])
        out["gateway"] = _node_gateway(srv, durable["scrape"], args)
        out["scheduler"] = _node_scheduler(srv)
        out["control"] = _node_control(srv)
    finally:
        srv.shutdown()
    log("  shutdown; boot 2:")
    srv, boot2 = boot_node(path, dev, "boot 2 (snapshot + delta)")
    out["boot2"] = boot2
    try:
        if boot2["from_snapshot"] != 4:
            raise AssertionError("phase 12: boot 2 did not restore every "
                                 "shard from its index snapshot")
        out["first_queries"] = []
        for q, want in out["gateway"].pop("bodies").items():
            code, body, ms = http_get(srv.http.port,
                                      f"/promql/{NODE_DS}/api/v1/query",
                                      query=q, time=out["gateway"]["at_s"])
            if code != 200 or body != want:
                raise AssertionError(f"phase 12: boot 2: {q} differs from "
                                     f"the live node's answer")
            out["first_queries"].append({"query": q, "cold_ms": ms})
            log(f"  boot 2: {q}: cold {ms:.1f} ms, byte-equal to the live "
                f"node's answer")
    finally:
        srv.shutdown()
    log(f"  index restore {boot2['index_s']:.2f} s from the snapshot against "
        f"{boot1['index_s']:.2f} s by the part-key scan in boot 1")
    launches = {k: _build.LAUNCHES[k] - side[k] for k in side}
    out["launches"] = launches
    log(f"  launches behind the HTTP API in phase 12: {launches}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing and dev.type == "cuda":
        raise AssertionError(f"phase 12: kernels not launched behind the "
                             f"HTTP API: {missing}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 12 took {out['seconds']:.1f} s")
    return out


def _http_headers(port: int, path: str, **params) -> tuple:
    """(status, headers, body) of one GET."""
    import urllib.error
    import urllib.parse
    import urllib.request

    url = f"http://127.0.0.1:{port}{path}?" + urllib.parse.urlencode(params)
    try:
        with urllib.request.urlopen(url, timeout=900) as r:
            return r.status, dict(r.headers), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


def _node_control(srv) -> dict:
    """Step 6: the node's control plane through HTTP: a request the
    governor sheds (503 with ``Retry-After``), one past its deadline (503
    ``timeout``), and ``debug/slow_queries`` and ``debug/costmodel``."""
    import threading

    from filodb_tpu_torch.utils import governor, resilience

    api = f"/promql/{NODE_DS}/api/v1/"
    q = DURABLE_QUERIES[0]
    saved = dict(vars(governor.config()))
    governor.configure(admission_capacity=1, max_queue_wait_s=0.05)
    held, release = threading.Event(), threading.Event()

    def occupant():
        with governor.governor().admit():
            held.set()
            release.wait(timeout=60)

    th = threading.Thread(target=occupant, daemon=True)
    th.start()
    held.wait(timeout=10)
    try:
        # a grid no cache holds: the front runs it, the governor sheds it
        shed = _http_headers(srv.http.port, api + "query_range", query=q,
                             start=T0_MS // 1000, end=DURABLE_END_S,
                             step=120)
    finally:
        release.set()
        th.join(timeout=60)
        governor.configure(**saved)
    timeout_s = resilience.config().query_timeout_s
    resilience.configure(query_timeout_s=0.001)
    try:
        # a data range no batch covers: its build outlasts 1 ms
        late = _http_headers(srv.http.port, api + "query_range", query=q,
                             start=T0_MS // 1000 + 7, end=DURABLE_END_S,
                             step=60)
    finally:
        resilience.configure(query_timeout_s=timeout_s)
    slow = json.loads(http_get(srv.http.port, api + "debug/slow_queries",
                               limit=5)[1])["data"]["slow_queries"]
    costs = json.loads(http_get(srv.http.port, api + "debug/costmodel")[1])
    out = {"shed": {"status": shed[0],
                    "retry_after": shed[1].get("Retry-After"),
                    "error_type": json.loads(shed[2]).get("errorType")},
           "deadline": {"status": late[0],
                        "retry_after": late[1].get("Retry-After"),
                        "error_type": json.loads(late[2]).get("errorType")},
           "slow_queries": [{"query": e.get("query"),
                             "duration_ms": e["duration_ms"],
                             "batched": e.get("batched", False)}
                            for e in slow],
           "costmodel": {k: costs["data"][k] for k in
                         ("enabled", "min_samples", "signatures",
                          "calibration_error")},
           "costmodel_sites": sorted({r["site"] for r in
                                      costs["data"]["estimates"]})}
    if out["shed"]["status"] != 503 or not out["shed"]["retry_after"] \
            or out["shed"]["error_type"] != "unavailable" \
            or out["deadline"]["status"] != 503 \
            or out["deadline"]["error_type"] != "timeout":
        raise AssertionError(f"phase 12: the control plane: {out}")
    log(f"  shed: 503 Retry-After {out['shed']['retry_after']} "
        f"({out['shed']['error_type']}); past a 1 ms deadline: 503 "
        f"({out['deadline']['error_type']}); debug/slow_queries "
        f"{len(slow)} entries (limit 5); debug/costmodel "
        f"{out['costmodel']['signatures']} signatures, sites "
        f"{out['costmodel_sites']}")
    return out


def _answer(svc, q: str):
    """The engine's answer for ``q`` over phase 11's range, past the
    extent cache (its whole-range batch is the one the plain checks
    read)."""
    return svc._execute_uncached(_parsed(q)).result


def _parsed(q: str):
    from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query

    return parse_query(q, TimeStepParams(T0_MS // 1000, 60, DURABLE_END_S))


def _node_queries(srv, durable: dict, side: dict) -> dict:
    """Step 2: each query through the HTTP API, cold then warm, its body's
    data byte-equal to phase 11's live answer; in-process warm beside (its
    launches added to ``side``)."""
    from filodb_tpu_torch import _build

    svc = srv.services[NODE_DS]
    store = srv.node.memstores[NODE_DS]
    res = {"http": []}
    params = dict(start=T0_MS // 1000, end=DURABLE_END_S, step=60)
    for q in DURABLE_QUERIES:
        paging = _paging_seconds(store)
        code, body, cold = http_get(srv.http.port, f"/promql/{NODE_DS}/api/"
                                    "v1/query_range", query=q, **params)
        split = {k: (v - paging[k]) * 1000.0
                 for k, v in _paging_seconds(store).items()}
        if code != 200 or body_data(body) != durable["bodies"][q]:
            raise AssertionError(f"phase 12: {q} through HTTP differs from "
                                 f"phase 11's live answer ({code})")
        warm = [http_get(srv.http.port, f"/promql/{NODE_DS}/api/v1/"
                         "query_range", query=q, **params)[2]
                for _ in range(NODE_WARM)]
        # the same with the rendered-response cache off: the extent cache
        # answers, the body is rendered again
        cache, srv.http.response_cache = srv.http.response_cache, None
        try:
            no_rc = []
            for _ in range(NODE_WARM):
                code, body2, ms = http_get(
                    srv.http.port, f"/promql/{NODE_DS}/api/v1/query_range",
                    query=q, **params)
                if code != 200 or body_data(body2) != durable["bodies"][q]:
                    raise AssertionError(f"phase 12: {q} without the "
                                         f"response cache differs")
                no_rc.append(ms)
        finally:
            srv.http.response_cache = cache
        inproc, before = [], dict(_build.LAUNCHES)
        for _ in range(NODE_WARM):
            t = time.perf_counter()
            svc.query_range(q, T0_MS // 1000, 60, DURABLE_END_S)
            inproc.append((time.perf_counter() - t) * 1000.0)
        for k in side:
            side[k] += _build.LAUNCHES[k] - before[k]
        entry = {"query": q, "cold_ms": cold, "cold_split_ms": split,
                 "warm_p50_ms": float(np.median(warm)),
                 "warm_p50_no_response_cache_ms": float(np.median(no_rc)),
                 "inprocess_p50_ms": float(np.median(inproc)),
                 "body_bytes": len(body)}
        res["http"].append(entry)
        log(f"  HTTP {q}: cold {cold:.1f} ms (store read {split['read']:.0f},"
            f" decode {split['decode']:.0f}, page encode "
            f"{split['encode']:.0f}), warm p50 "
            f"{entry['warm_p50_ms']:.2f} ms (response cache off: "
            f"{entry['warm_p50_no_response_cache_ms']:.2f}) against "
            f"{entry['inprocess_p50_ms']:.2f} ms in process (extent cache); "
            f"body ({len(body)} bytes) byte-equal to phase 11's live answer")
    rc = srv.http.response_cache
    res["response_cache"] = {"hits": rc.hits, "misses": rc.misses}
    log(f"  response cache: {rc.hits} hits, {rc.misses} misses")
    return res


def _node_concurrency(srv, bodies: dict) -> dict:
    """Step 3: client threads each sending both queries several times,
    with the response cache on and then off (every query reaches the fast
    front end's hot batches: the batch sizes a pass); every body's data
    byte-equal to the live answer."""
    out = {}
    cache = srv.http.response_cache
    for name in ("response cache on", "response cache off"):
        srv.http.response_cache = cache if name.endswith("on") else None
        srv.http.batch_sizes.clear()
        h0, m0 = cache.hits, cache.misses
        try:
            out[name] = _node_clients(srv, bodies)
        finally:
            srv.http.response_cache = cache
        out[name].update(batch_sizes=list(srv.http.batch_sizes),
                         hits=cache.hits - h0, misses=cache.misses - m0)
        log(f"  ({name}: hot batch sizes a pass "
            f"{out[name]['batch_sizes']}; response cache "
            f"{out[name]['hits']} hits, {out[name]['misses']} misses)")
    return out


def _node_clients(srv, bodies: dict) -> dict:
    """``NODE_CONCURRENCY`` client threads, each sending both queries
    several times."""
    from concurrent.futures import ThreadPoolExecutor

    threads, rounds = NODE_CONCURRENCY
    params = dict(start=T0_MS // 1000, end=DURABLE_END_S, step=60)

    def client(_):
        got = []
        for _ in range(rounds):
            for q in DURABLE_QUERIES:
                code, body, ms = http_get(srv.http.port, f"/promql/{NODE_DS}"
                                          "/api/v1/query_range", query=q,
                                          **params)
                got.append((q, code, body_data(body) == bodies[q], ms))
        return got

    t = time.perf_counter()
    with ThreadPoolExecutor(threads) as pool:
        results = [r for rs in pool.map(client, range(threads)) for r in rs]
    wall = time.perf_counter() - t
    bad = [(q, c) for q, c, same, _ in results if c != 200 or not same]
    if bad:
        raise AssertionError(f"phase 12: concurrent bodies differ: {bad[:3]}")
    ms = [r[3] for r in results]
    out = {"threads": threads, "requests": len(results), "wall_s": wall,
           "p50_ms": float(np.median(ms)), "max_ms": float(max(ms))}
    log(f"  {threads} threads x {rounds} rounds x 2 queries: {len(results)} "
        f"bodies byte-equal, {wall:.2f} s, p50 {out['p50_ms']:.1f} ms, max "
        f"{out['max_ms']:.1f} ms")
    return out


def _node_gateway(srv, scrape, args) -> dict:
    """Step 4: one more scrape of every series as Influx lines over TCP,
    10 s after the last; lines a second, seconds until instant queries at
    the scrape time see all of it, and ``sum(rate)`` latency meanwhile."""
    import math
    import socket
    import threading

    from filodb_tpu_torch.gateway import server as gw

    keys, ts1, vals1 = scrape
    rng = np.random.default_rng([args.seed, 12])
    ts2 = ts1 + 10_000
    vals2 = np.where(np.isnan(vals1), 0.0, vals1) \
        + rng.integers(1, 20, len(vals1))
    lines = []
    for k, t, v in zip(keys, ts2.tolist(), vals2.tolist()):
        tags = ",".join(f"{a}={b}" for a, b in k.labels if a != "_metric_")
        lines.append(f"{k.metric},{tags} counter={v!r} {t * 1_000_000}\n")
    payload = "".join(lines).encode()
    n = len(lines)
    at_s = int(math.ceil(int(ts2.max()) / 1000))
    parsed0 = gw.lines_parsed.value
    workers = list(srv.node._workers.values())
    offsets0 = [w.offset for w in workers]
    dashboard, stop = [], threading.Event()

    def dash():
        # a dashboard refreshing while the scrape lands: from the first
        # container a shard ingested until the last
        while not stop.is_set() and all(
                w.offset == o for w, o in zip(workers, offsets0)):
            time.sleep(0.01)
        q = DURABLE_QUERIES[0]
        while not stop.is_set():
            code, _, ms = http_get(srv.http.port, f"/promql/{NODE_DS}/api/v1/"
                                   "query_range", query=q,
                                   start=T0_MS // 1000, end=DURABLE_END_S,
                                   step=60)
            dashboard.append((code, ms))

    def send():
        with socket.create_connection(("127.0.0.1", srv.gateway.port)) as c:
            c.sendall(payload)

    t0 = time.perf_counter()
    sender = threading.Thread(target=send)
    sender.start()
    dash_thread = threading.Thread(target=dash)
    dash_thread.start()
    parsed_s = ingested_s = None
    deadline = t0 + 900
    while time.perf_counter() < deadline:
        if parsed_s is None and gw.lines_parsed.value - parsed0 >= n:
            parsed_s = time.perf_counter() - t0
        if parsed_s is not None:
            srv.gateway.sink.flush()
            if all(w.offset >= w.log.latest_offset for w in workers):
                ingested_s = time.perf_counter() - t0
                break
        time.sleep(0.01)
    stop.set()
    sender.join(timeout=60)
    if ingested_s is None:
        raise AssertionError("phase 12: the gateway scrape was not ingested "
                             "in time")
    dash_thread.join(timeout=900)
    dash_wait_s = time.perf_counter() - t0 - ingested_s
    if dash_thread.is_alive() or any(c != 200 for c, _ in dashboard):
        raise AssertionError(f"phase 12: sum(rate) during the ingest: "
                             f"{dashboard}")
    dashboard = [ms for _, ms in dashboard]
    app0 = np.array([k.label_map["_ns_"] == "App-0" for k in keys])
    want = {"count(http_requests_total)": float(n),
            "sum(http_requests_total)": float(vals2.sum()),
            NODE_FIRST_QUERY: float(vals2[app0].sum())}
    bodies, t_query = {}, time.perf_counter()
    for q, value in want.items():
        while True:
            code, body, ms = http_get(srv.http.port, f"/promql/{NODE_DS}/"
                                      "api/v1/query", query=q, time=at_s)
            res = json.loads(body)["data"]["result"] if code == 200 else []
            if res and float(res[0]["value"][1]) == value:
                break
            if time.perf_counter() > deadline:
                raise AssertionError(f"phase 12: {q} at {at_s}: {body[:200]}"
                                     f" (want {value})")
            time.sleep(0.05)
        bodies[q] = body
    visible_s = time.perf_counter() - t0
    bodies = {NODE_FIRST_QUERY: bodies[NODE_FIRST_QUERY]}
    out = {"lines": n, "bytes": len(payload), "parsed_s": parsed_s,
           "lines_per_s": n / parsed_s, "ingested_s": ingested_s,
           "dashboard_wait_s": dash_wait_s,
           "visible_query_s": time.perf_counter() - t_query,
           "visible_s": visible_s, "at_s": at_s, "sum_sent": want[
               "sum(http_requests_total)"],
           "during_ingest_ms": dashboard,
           "during_ingest_p50_ms": float(np.median(dashboard))
           if dashboard else None, "bodies": bodies}
    log(f"  gateway: {n} Influx lines ({len(payload) / 1e6:.1f} MB) parsed "
        f"in {parsed_s:.1f} s ({out['lines_per_s']:.0f} lines/s), ingested "
        f"{ingested_s:.1f} s after the first byte, visible to instant count "
        f"and sum (and App-0's sum) at {at_s} after {visible_s:.1f} s (the "
        f"last in-flight "
        f"sum(rate) ended {dash_wait_s:.1f} s after the ingest, the two "
        f"instant queries took {out['visible_query_s']:.1f} s; sum "
        f"{want['sum(http_requests_total)']:.0f} equal to the sum sent); "
        f"sum(rate) while ingesting: "
        f"{len(dashboard)} queries, {[round(x) for x in dashboard]} ms")
    return out


def _node_scheduler(srv) -> dict:
    """Step 5: the flush scheduler at a short tick until every shard has
    a checkpoint in every group, truncated its log below its smallest
    watermark and written its index snapshot. Each shard's round robin
    starts at the first group phase 11 left without a checkpoint (a group
    flush of this store takes about a second on the host of an NVIDIA
    H100 80GB HBM3 machine: sqlite inserts into a 400 MB table)."""
    from filodb_tpu_torch.coordinator.cluster import _FlushScheduler

    node = srv.node
    node._flusher.stop()
    node.flush_tick_s = NODE_TICK_S
    node._flusher = sched = _FlushScheduler(node, NODE_TICK_S)
    shards = node.memstores[NODE_DS].shards
    for sh in shards:
        sh._last_flushed_group = int(np.argmin(sh.group_watermarks)) - 1
    flushes0 = [sh.stats.flushes_done.value for sh in shards]
    t = time.perf_counter()
    sched.start()
    keys = [(NODE_DS, s) for s in range(len(shards))]
    deadline = t + 600
    while time.perf_counter() < deadline:
        if all(sh.group_watermarks.min() >= 0 for sh in shards) \
                and all(k in sched.truncated for k in keys) \
                and all(sched.snapshots.get(k, (0, 0))[0] for k in keys):
            break
        time.sleep(0.05)
    else:
        raise AssertionError("phase 12: the scheduler did not flush, "
                             "truncate and snapshot every shard in time")
    out = {"tick_s": NODE_TICK_S, "seconds": time.perf_counter() - t,
           "flushes": [sh.stats.flushes_done.value - f0
                       for sh, f0 in zip(shards, flushes0)],
           "min_watermarks": [int(sh.group_watermarks.min())
                              for sh in shards],
           "truncated_before": [sched.truncated[k][0] for k in keys],
           "segments_removed": [sched.truncated[k][1] for k in keys],
           "snapshot_bytes": [sched.snapshots[k][1] for k in keys]}
    log(f"  scheduler at a {NODE_TICK_S} s tick: {out['flushes']} group "
        f"flushes a shard in {out['seconds']:.1f} s; logs truncated below "
        f"{out['truncated_before']} ({out['segments_removed']} segments "
        f"removed: a segment holds 4,096 containers); index snapshots of "
        f"{out['snapshot_bytes']} bytes")
    return out


# phase 13: the shard's memory bound on the card. A store of its own: the
# phase-2 generator's first EVICT_SERIES series (500 a namespace) on a
# local-disk store, 20 flush groups a shard, a budget of EVICT_MEM_MB a
# shard (about half a shard's chunk bytes, as 30 MiB was of 100,000
# series' and 15 MiB of 50,000 series' before the cuts that keep the smoke
# in its limit, PERF.md §4)
# and a retention of EVICT_RETENTION_MS. One more scrape reaches
# App-50..App-99 only, so App-0..App-49 stop: the scheduler's tick evicts
# their chunks, evict_cold_partitions then the partitions, App-0 comes back
# through the bloom and purge_expired drops the rest.
EVICT_SERIES = 25_000  # 50,000 until phase 21 came (PERF.md §4)
EVICT_MEM_MB = 8
EVICT_RETENTION_MS = 1_800_000  # 30 min past a series' last sample
EVICT_QUERIES = (f"sum(rate({M}[5m])) by (_ns_)",
                 f"sum(count_over_time({M}[5m])) by (job)")
EVICT_INSTANT = f"count({M})"
EVICT_WARM = 3


def _bodies(services, queries, start: int, end: int) -> dict:
    """(engine, query) → the sorted answer of each query on each engine
    over [start, end] at 60 s."""
    return {(name, q): _sorted_answer(svc.query_range(q, start, 60, end))
            for name, svc in services.items() for q in queries}


def _ns_of(key: str) -> int:
    """The namespace number of an answer's key (``App-<n>``), -1 if
    none."""
    import re

    m = re.search(r"App-(\d+)", key)
    return int(m.group(1)) if m else -1


def _same_rows(got, want, keep, what: str) -> None:
    """The rows of ``got`` and ``want`` whose key ``keep`` holds, byte for
    byte."""
    gk, gv = got
    wk, wv = want
    gi = [i for i, k in enumerate(gk) if keep(k)]
    wi = [i for i, k in enumerate(wk) if keep(k)]
    if [gk[i] for i in gi] != [wk[i] for i in wi] or not gi \
            or gv[gi].tobytes() != wv[wi].tobytes():
        raise AssertionError(f"phase 13: {what}")


def eviction_phase(dev, args) -> dict:
    """Phase 13 (see the module): eviction and purge on the card."""
    import gc

    import torch

    from filodb_tpu_torch import _build
    from filodb_tpu_torch.coordinator.cluster import shard_tick
    from filodb_tpu_torch.core.memstore.shard import EVICTED, GONE
    from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="filodb-evict-")
    n = min(args.evict_series, args.series)
    cfg = dict(shard_mem_mb=EVICT_MEM_MB, retention_ms=EVICT_RETENTION_MS)
    log(f"phase 13: eviction and purge on the card: {n} series on a "
        f"local-disk store under {root}, shard_mem_mb {EVICT_MEM_MB}, "
        f"retention_ms {EVICT_RETENTION_MS}")
    store = durable_store(root, "evict", **cfg)
    shards = store.shards
    t = time.perf_counter()
    ingest(store, n, args.samples, args.seed)
    out = {"series": n, "ingest_s": time.perf_counter() - t}
    keys, ts, vals = last_samples(store)
    # 1. flush
    t = time.perf_counter()
    out["flush"] = {"chunks": store.flush_all(),
                    "seconds": time.perf_counter() - t}
    # 2. one more scrape of App-50..App-99: App-0..App-49 stop
    ns = np.array([int(k.label_map["_ns_"][4:]) for k in keys])
    go = ns >= 50
    stopped_last = int(ts[~go].max())
    store.ingest_series([keys[i].label_map for i in np.flatnonzero(go)],
                        (ts[go] + 10_000)[:, None],
                        (vals[go] + 1.0)[:, None])
    n_stopped = int((~go).sum())
    log(f"  ingest {out['ingest_s']:.1f} s, flush {out['flush']['chunks']} "
        f"chunks in {out['flush']['seconds']:.1f} s; one more scrape of "
        f"App-50..App-99 ({int(go.sum())} series), {n_stopped} stopped")
    # 3. the answers before
    start, end = T0_MS // 1000, DURABLE_END_S
    engines = {"mesh": smoke_service(store, device=dev),
               "exec": smoke_service(store, device=dev, engine="exec")}
    before = _bodies(engines, EVICT_QUERIES, start, end)
    count0 = engines["mesh"].query_instant(EVICT_INSTANT, end)
    if count0.result.values[0, 0] != n:
        raise AssertionError(f"phase 13: count before: "
                             f"{count0.result.values}")
    # 4. one scheduler tick at the budget
    mem0 = [sh.chunk_bytes() for sh in shards]
    t = time.perf_counter()
    ticks = [shard_tick(sh, end * 1000) for sh in shards]
    out["tick"] = {"seconds": time.perf_counter() - t, "bytes_before": mem0,
                   "bytes_after": [sh.chunk_bytes() for sh in shards],
                   "chunks_evicted": [k["evicted"] for k in ticks],
                   "flushed": [k["flushed"] for k in ticks],
                   "purged": [k["purged"] for k in ticks]}
    if max(out["tick"]["bytes_after"]) > EVICT_MEM_MB * 2**20 \
            or sum(out["tick"]["purged"]):
        raise AssertionError(f"phase 13: the tick: {out['tick']}")
    log(f"  scheduler tick: chunk bytes a shard {mem0} -> "
        f"{out['tick']['bytes_after']} (budget {EVICT_MEM_MB} MiB), "
        f"{out['tick']['chunks_evicted']} chunks evicted, "
        f"{out['tick']['seconds']:.2f} s")
    # 5. evict the stopped half
    stopped = [np.flatnonzero(sh.latest[:sh.num_partitions] <= stopped_last)
               for sh in shards]
    app0_f = list(parse_query('http_requests_total{_ns_="App-0"}',
                              TimeStepParams(0, 0, 0)).raw.filters)
    app0_starts = np.concatenate([sh.index.start_times(
        sh.lookup_partitions(app0_f, 0, 2**62)) for sh in shards])
    t = time.perf_counter()
    evicted = [sh.evict_cold_partitions(len(st))
               for sh, st in zip(shards, stopped)]
    out["evict"] = {"partitions": evicted,
                    "seconds": time.perf_counter() - t}
    if sum(evicted) != n_stopped or any(
            (sh.status[st] != EVICTED).any()
            for sh, st in zip(shards, stopped)):
        raise AssertionError(f"phase 13: evicted {evicted}, stopped "
                             f"{n_stopped}")
    log(f"  evict_cold_partitions: {evicted} partitions a shard in "
        f"{out['evict']['seconds']:.2f} s")
    # 6. the answers again: the shells page in, bitwise as before
    torch.cuda.synchronize()
    _build.reset_counts()
    out["queries"] = []
    for (name, q), want in before.items():
        svc = engines[name]
        p0 = _paging_seconds(store)
        t = time.perf_counter()
        got = _sorted_answer(svc.query_range(q, start, 60, end))
        cold = (time.perf_counter() - t) * 1000.0
        split = {k: v - p0[k] for k, v in _paging_seconds(store).items()}
        warm = []
        for _ in range(EVICT_WARM):
            t = time.perf_counter()
            got = _sorted_answer(svc.query_range(q, start, 60, end))
            warm.append((time.perf_counter() - t) * 1000.0)
        if got[0] != want[0] or got[1].tobytes() != want[1].tobytes():
            raise AssertionError(f"phase 13: {name} {q} after eviction is "
                                 f"not bitwise the answer before")
        rec = {"engine": name, "query": q, "cold_ms": cold, "split_s": split,
               "warm_p50_ms": float(np.median(warm))}
        out["queries"].append(rec)
        log(f"  {name} {q}: cold {cold:.1f} ms (store read "
            f"{split['read']:.2f} s, C++ decode {split['decode']:.2f} s, page "
            f"encode {split['encode']:.2f} s, the rest pack and upload), "
            f"warm p50 {rec['warm_p50_ms']:.2f} ms, bitwise as before")
    count1 = engines["mesh"].query_instant(EVICT_INSTANT, end)
    if count1.result.values.tobytes() != count0.result.values.tobytes():
        raise AssertionError("phase 13: instant count after eviction")
    launches = dict(_build.LAUNCHES)
    out["launches"] = launches
    missing = [k for k, v in launches.items() if v == 0]
    if missing and dev.type == "cuda":
        raise AssertionError(f"phase 13: kernels not launched on the paged "
                             f"shells: {missing}")
    mem_before = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    log(f"  launches over the paged shells: {launches}")
    # 7. App-0's series come back: the bloom restores their identity
    q0 = [sh.stats.bloom_queries.value for sh in shards]
    f0 = [sh.stats.bloom_fp.value for sh in shards]
    r0 = [sh.stats.partitions_restored.value for sh in shards]
    back_ts = end * 1000 + 60_000
    app0 = [k for k, x in zip(keys, ns) if x == 0]
    store.ingest_series([k.label_map for k in app0],
                        np.full((len(app0), 1), back_ts), np.ones(
                            (len(app0), 1)))
    restored = sum(sh.stats.partitions_restored.value - r
                   for sh, r in zip(shards, r0))
    out["bloom"] = {
        "queries": sum(sh.stats.bloom_queries.value - q
                       for sh, q in zip(shards, q0)),
        "false_positives": sum(sh.stats.bloom_fp.value - f
                               for sh, f in zip(shards, f0)),
        "restored": restored}
    new_pids = [sh.lookup_partitions(app0_f, 0, 2**62) for sh in shards]
    starts = np.concatenate([sh.index.start_times(p) for sh, p in
                             zip(shards, new_pids)])
    gap = engines["mesh"].query_range(
        f'count_over_time({M}{{_ns_="App-0"}}[5m])', start, 60,
        back_ts // 1000).result
    gap.materialize()
    if restored != len(app0) or sorted(starts.tolist()) != sorted(
            app0_starts.tolist()) or gap.num_series != len(app0) \
            or not np.isfinite(gap.values[:, [1, -1]]).all():
        raise AssertionError(f"phase 13: App-0's return: {out['bloom']}, "
                             f"{gap.num_series} series")
    log(f"  App-0's {len(app0)} series scraped again: bloom queries "
        f"{out['bloom']['queries']}, false positives "
        f"{out['bloom']['false_positives']}, restored {restored}; start "
        f"times kept, count_over_time continuous across the gap")
    # 8. purge past the retention
    now = stopped_last + EVICT_RETENTION_MS + 1000
    t = time.perf_counter()
    purged = [sh.purge_expired(now) for sh in shards]
    out["purge"] = {"partitions": purged,
                    "seconds": time.perf_counter() - t}
    if sum(purged) != n_stopped - len(app0):
        raise AssertionError(f"phase 13: purged {purged}, expected "
                             f"{n_stopped - len(app0)}")
    log(f"  purge_expired: {purged} partitions a shard (the stopped series "
        f"not scraped again) in {out['purge']['seconds']:.3f} s")
    # 9. the survivors as before, the purged absent, their batches freed
    after = _bodies(engines, EVICT_QUERIES, start, end)
    for key, want in before.items():
        got = after[key]
        if key[1].endswith("by (_ns_)"):
            _same_rows(got, want, lambda k: _ns_of(k) >= 50,
                       f"{key}: the survivors' rows")
            if any(1 <= _ns_of(k) < 50 for k in got[0]):
                raise AssertionError(f"phase 13: {key}: purged rows")
    app_f = parse_query('http_requests_total{_ns_="App-1"}',
                        TimeStepParams(0, 0, 0)).raw.filters
    if engines["mesh"].series(app_f, start, end):
        raise AssertionError("phase 13: series() returns purged series")
    gc.collect()
    mem_after = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    out["memory_allocated"] = {"before": mem_before, "after": mem_after}
    log(f"  survivors' rows byte-equal to before, purged series absent from "
        f"the answers and from series(); memory_allocated "
        f"{mem_before / 1e9:.3f} -> {mem_after / 1e9:.3f} GB once the "
        f"purged batches were replaced")
    # 10. an index snapshot with the holes and the bloom, restored
    store.flush_all()
    live = _sorted_answer(engines["mesh"].query_range(EVICT_QUERIES[0],
                                                      start, 60, end))
    snap = [sh.snapshot_index() for sh in shards]
    holes = sum(int((sh.status[:sh.num_partitions] == GONE).sum())
                for sh in shards)
    store.close()
    del engines, store, shards
    gc.collect()
    torch.cuda.empty_cache()
    again = durable_store(root, "evict", **cfg)
    t = time.perf_counter()
    for s in range(again.num_shards):
        again.recover_index(s)
    restore_s = time.perf_counter() - t
    first = _sorted_answer(smoke_service(again, device=dev).query_range(
        EVICT_QUERIES[0], start, 60, end))
    if any(sh.recovered_from != "snapshot" for sh in again.shards) \
            or first[0] != live[0] or first[1].tobytes() != live[1] \
            .tobytes():
        raise AssertionError("phase 13: the snapshot's restore")
    out["snapshot"] = {"bytes": snap, "holes": holes,
                       "restore_s": restore_s}
    log(f"  index snapshots of {snap} bytes ({holes} holes, the bloom); "
        f"restored in {restore_s:.2f} s without the scan, first query "
        f"byte-equal")
    again.close()
    out["bytes_freed"] = remove_dir(root)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 13 took {out['seconds']:.1f} s")
    return out


# phase 14: the host-decode lane. Three metrics a node exporter and a
# process exporter scrape, whose values float32 does not hold: byte
# counters past 2^24, CPU seconds in hundredths, load averages with two
# decimals (the series of each, in this order, as shares of
# ``--host-series``)
NB_BYTES = "node_network_receive_bytes_total"
CPU_S = "process_cpu_seconds_total"
LOAD1 = "node_load1"
HOST_SERIES = 50_000  # (PERF.md §4; 150,000 until phase 21 came)
HOST_SHARES = ((NB_BYTES, "prom-counter", 10), (CPU_S, "prom-counter", 4),
               (LOAD1, "gauge", 1))
HOST_QUERIES = (f"sum(rate({NB_BYTES}[5m])) by (_ns_)",
                f"sum(increase({CPU_S}[5m])) by (job)",
                f"max(irate({NB_BYTES}[5m])) by (_ns_)",
                f"sum(idelta({LOAD1}[5m])) by (job)",
                f"sum(deriv({LOAD1}[10m])) by (_ns_)",
                f"sum(changes({CPU_S}[5m])) by (job)",
                f"avg(stddev_over_time({LOAD1}[5m])) by (_ns_)")
# the instant query at the range's end: the service's mesh engine hands it
# to exec, whose leaves try the sidecar lane first
HOST_INSTANT = f"sum(rate({NB_BYTES}[5m])) by (_ns_)"
HOST_WARM = 5
HOST_SUBSET = '_ns_=~"App-[0-9]"'  # the card-against-CPU check's series
HOST_TOL = dict(rtol=2e-5, atol=1e-6, equal_nan=True)


def make_host_series(rng, metric: str, a: int, b: int, samples: int):
    """Series a..b-1 of ``metric`` (labels as phase 2's): byte counters
    from integers in [1e9, 1e12) plus 0-1.25e6 a scrape, a reset in about
    5 % of series; CPU seconds from [1e3, 1e6) plus 0.01-0.5 s a scrape in
    hundredths; a load average 0-64 with two decimals, a random walk of
    0.01-0.5 either way."""
    n = b - a
    labels = [{"_metric_": metric, "_ws_": "demo", "_ns_": f"App-{i % 100}",
               "instance": f"instance-{i}", "job": f"job-{i % 10}"}
              for i in range(a, b)]
    ts = (T0_MS + np.arange(samples, dtype=np.int64)[None, :] * 10_000
          + rng.integers(-500, 501, (n, samples)))
    if metric == NB_BYTES:
        vals = (rng.integers(10**9, 10**12, (n, 1))
                + np.cumsum(rng.integers(0, 1_250_001, (n, samples)),
                            axis=1)).astype(np.float64)
        reset = np.flatnonzero(rng.random(n) < 0.05)
        at = rng.integers(1, samples, len(reset))
        for r, k in zip(reset, at):
            vals[r, k:] -= vals[r, k]
    elif metric == CPU_S:
        vals = (rng.integers(10**5, 10**8, (n, 1)) + np.cumsum(
            rng.integers(1, 51, (n, samples)), axis=1)) / 100.0
    else:
        walk = rng.integers(1, 51, (n, samples)) * rng.choice([-1, 1],
                                                               (n, samples))
        vals = np.clip(rng.integers(0, 6401, (n, 1)) + np.cumsum(walk, 1), 0,
                       6400) / 100.0
    return labels, ts, vals


def host_store(series: int, samples: int, seed: int):
    """The phase-14 store (phase 2's layout) and the series of it whose
    values do not survive float64 → float32 → float64."""
    from filodb_tpu_torch.core.memstore.partition import exact_in_f32

    store = main_store()
    rng = np.random.default_rng(seed + 14)
    total = sum(w for _, _, w in HOST_SHARES)
    inexact, step = 0, 65536
    for metric, schema, w in HOST_SHARES:
        n = series * w // total
        for a in range(0, n, step):
            labels, ts, vals = make_host_series(rng, metric, a,
                                                min(a + step, n), samples)
            inexact += int((~exact_in_f32(vals, np.full(len(vals),
                                                        samples))).sum())
            store.ingest_series(labels, ts, vals, schema=schema)
    return store, inexact


def _subset(q: str) -> str:
    """``q`` with every selector of the three metrics cut to the
    ``HOST_SUBSET`` namespaces."""
    for m, _, _ in HOST_SHARES:
        q = q.replace(f"{m}[", f"{m}{{{HOST_SUBSET}}}[")
    return q


def _same(got, want, what: str) -> dict:
    """The card's answer against the CPU's, rows by key, within
    ``HOST_TOL``; → the largest absolute difference, and the largest
    relative one where the CPU's value passes the ``atol``."""
    gk, gv = _sorted_answer(got)
    wk, wv = _sorted_answer(want)
    if gk != wk or gv.shape != wv.shape or not np.allclose(gv, wv,
                                                           **HOST_TOL):
        raise AssertionError(f"phase 14: {what}: the card's answer is not "
                             f"the CPU's")
    fin = np.isfinite(wv)
    diff, ref = np.abs(gv[fin] - wv[fin]), np.abs(wv[fin])
    big = ref > HOST_TOL["atol"]
    return {"max_abs": float(diff.max(initial=0.0)),
            "max_rel": float((diff[big] / ref[big]).max(initial=0.0))}


def host_lane_phase(dev, args) -> dict:
    """Phase 14: the host-decode lane at a real scale (see the module)."""
    from filodb_tpu_torch import _build
    from filodb_tpu_torch.query.engine.batch import SeriesBatch

    t_phase = t = time.perf_counter()
    store, inexact = host_store(args.host_series, args.samples, args.seed)
    log(f"phase 14: the host-decode lane: {args.host_series} series "
        f"({', '.join(m for m, _, _ in HOST_SHARES)}), {args.samples} "
        f"samples, ingested in {time.perf_counter() - t:.1f} s; "
        f"{inexact} series fail the float32 round trip")
    start, end = T0_MS // 1000, END_S
    out = {"series": args.host_series, "inexact_series": inexact,
           "ingest_s": time.perf_counter() - t, "queries": []}
    services = {e: smoke_service(store, device=dev, engine=e)
                for e in ("mesh", "exec")}
    cpu = smoke_service(store, device="cpu")
    _build.reset_counts()
    for q in HOST_QUERIES:
        sub = _subset(q)
        want = cpu.query_range(sub, start, 60, end)
        for engine, svc in services.items():
            before = {id(b) for b in svc.batches.batches()}
            t = time.perf_counter()
            r = svc.query_range(q, start, 60, end)
            cold = (time.perf_counter() - t) * 1000.0
            if engine == "mesh":
                on_mesh(r, q)
            # the build seconds of the batches this query built (a batch
            # the query found cached rebases for it if it must)
            built = [b for b in svc.batches.batches()
                     if isinstance(b, SeriesBatch) and id(b) not in before]
            split = {k: sum(b.seconds.get(k, 0.0) for b in built)
                     for k in ("select", "decode", "layout", "rebase",
                               "upload")}
            split["rest"] = cold / 1000.0 - sum(split.values())
            warm = []
            for _ in range(HOST_WARM):
                t = time.perf_counter()
                r = svc.query_range(q, start, 60, end)
                warm.append((time.perf_counter() - t) * 1000.0)
            if r.stats.host_lane == 0 or r.stats.precise_lane:
                raise AssertionError(f"phase 14: {q} on {engine} did not "
                                     f"take the host-decode lane")
            rel = _same(svc.query_range(sub, start, 60, end), want,
                        f"{sub} ({engine})")
            rec = dict(query=q, engine=engine, cold_ms=cold,
                       cold_split_s=split,
                       warm_p50_ms=float(np.median(warm)),
                       rows=r.result.num_series,
                       host_lane=r.stats.host_lane,
                       samples_scanned=r.stats.samples_scanned,
                       vs_cpu=rel)
            out["queries"].append(rec)
            log(f"  {engine} {q}: cold {cold:.1f} ms (host s: "
                f"{', '.join(f'{k} {v:.2f}' for k, v in split.items())}), "
                f"warm p50 {rec['warm_p50_ms']:.2f} ms, {rec['rows']} rows, "
                f"{r.stats.host_lane} host-lane batches; the subset equals "
                f"the CPU's (max abs {rel['max_abs']:.2e}, rel "
                f"{rel['max_rel']:.2e})")
    # at the end the windows hold write-buffer samples only, which the
    # sidecar lane folds in float64; an hour earlier they cut a sealed
    # chunk, an edge the lane would decode in float32: with the fold
    # forced past the static gate, it bypasses for that
    from filodb_tpu_torch.query.engine import sidecar_lane

    out["instant"] = []
    for at, folded in ((end, True), (end - 3600, False)):
        served = sidecar_lane.SIDECAR_SERVED.value
        t = time.perf_counter()
        with valves(**({} if folded else
                       {"FILODB_SIDECAR_SEALED_GATE": "0"})):
            r = services["mesh"].query_instant(HOST_INSTANT, at)
        inst_ms = (time.perf_counter() - t) * 1000.0
        lane = sidecar_lane.SIDECAR_SERVED.value > served
        bypassed = "values float32 does not hold" in \
            r.stats.sidecar_bypassed
        if r.stats.engine != "exec" or lane != folded \
                or bypassed == folded or bool(r.stats.host_lane) == folded:
            raise AssertionError(
                f"phase 14: the instant {HOST_INSTANT} at {at} was "
                f"{'not ' if folded else ''}folded by the sidecar lane "
                f"({r.stats})")
        sub = _subset(HOST_INSTANT)
        rel = _same(services["mesh"].query_instant(sub, at),
                    cpu.query_instant(sub, at), f"instant {sub} at {at}")
        out["instant"].append(dict(
            query=HOST_INSTANT, at_s=at, ms=inst_ms, sidecar_served=lane,
            sidecar_bypassed=r.stats.sidecar_bypassed,
            host_lane=r.stats.host_lane, vs_cpu=rel))
        log(f"  instant {HOST_INSTANT} at {at}: {inst_ms:.1f} ms through "
            f"exec ({'the sidecar lane, buffers folded in float64' if lane else f'sidecar bypassed: {r.stats.sidecar_bypassed}'}), "
            f"{r.stats.host_lane} host-lane batches; equal to the CPU's")
    out["launches"] = dict(_build.LAUNCHES)
    if out["launches"]["fused_decode_rate"]:
        raise AssertionError("phase 14: B3 launched on values float32 does "
                             "not hold")
    out["batch_bytes"] = {e: sum(b.nbytes for b in svc.batches.batches())
                          for e, svc in services.items()}
    log(f"  launches {out['launches']}; host-lane batches on the card: "
        f"{', '.join(f'{e} {v / 1e9:.2f} GB' for e, v in out['batch_bytes'].items())}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 14 took {out['seconds']:.1f} s")
    return out


# phase 15: the serving front end, on a store of the phase-2 generator's
# first SERVING_SERIES series. SERVING_BATCH range queries in flight, the
# four phase-3 shapes in turn, member i's 2 h range slid by (i mod 5)
# steps: many users of one dashboard refreshed at different moments (the
# reference's QueryInMemoryBenchmark shape, 100 concurrent queries cycling
# 4 plans); then a dashboard query through the extent cache at the
# reference's default block, before and after a scrape. Cut from the
# 1,000,000 series of phase 2: a batch of 1 M series takes about 9 GB on
# the card (P padded to 2^20), the batch cache holds four, and the 100
# queries one at a time, five data ranges in turn, rebuilt a batch for
# nearly every query (the phase ran past 20 minutes); then from 250,000
# to 150,000 and, when phase 16 came to run on this store, to 100,000
# (phase 11's count), then to 50,000 when phase 20 came and to 25,000
# when phase 21 came, to keep the smoke inside its limit (PERF.md §4)
SERVING_SERIES = 25_000
SERVING_BATCH = 100
SERVING_SHIFTS = 5
SERVING_QUERY = f"sum(rate({M}[5m])) by (_ns_)"
SERVING_WARM = 5
SERVING_TOL = dict(rtol=2e-5, atol=1e-6)


def _answers_agree(got, want, bitwise: bool) -> float:
    """Two materialized answers of one engine over one store: keys in the
    same order, NaN at the same places, values bit for bit or within
    ``SERVING_TOL``; → the largest absolute difference."""
    g, w = got.result, want.result
    if g.keys != w.keys \
            or g.values.shape != w.values.shape \
            or not np.array_equal(np.isnan(g.values), np.isnan(w.values)):
        raise AssertionError("phase 15: keys, shape or NaN positions differ")
    fin = np.isfinite(w.values)
    err = float(np.abs(g.values[fin] - w.values[fin]).max()) \
        if fin.any() else 0.0
    ok = np.array_equal(g.values, w.values, equal_nan=True) if bitwise \
        else np.allclose(g.values, w.values, equal_nan=True, **SERVING_TOL)
    if not ok:
        raise AssertionError(f"phase 15: answers differ by {err}")
    return err


def serving_batch(svc) -> dict:
    """Step 1: the in-flight batch through ``query_range_many``, cold then
    warm, against the same queries one at a time through ``query_range``,
    cold then warm; every member held against its single answer (B3's
    shapes bit for bit, the others within ``SERVING_TOL``)."""
    from filodb_tpu_torch import _build

    qs = []
    for i in range(SERVING_BATCH):
        end = END_S - (SERVING_SHIFTS - 1 - i % SERVING_SHIFTS) * 60
        qs.append((QUERIES[i % len(QUERIES)][0], end - 7200, 60, end))
    runs, batch = {}, None
    for name in ("cold", "warm"):
        _build.reset_counts()
        t = time.perf_counter()
        batch = svc.query_range_many(qs)
        runs[f"batch_{name}"] = {"ms": (time.perf_counter() - t) * 1000.0,
                                 "launches": dict(_build.LAUNCHES)}
        log(f"  {len(qs)} queries, batch {name}: "
            f"{runs[f'batch_{name}']['ms']:.1f} ms")
    engines = sorted({r.stats.engine for r in batch})
    if engines != ["mesh"]:
        raise AssertionError(f"phase 15: the batch ran on {engines}")
    errs = {}
    for name in ("cold", "warm"):
        _build.reset_counts()
        total, t_run = 0.0, time.perf_counter()
        for q, got in zip(qs, batch):
            t = time.perf_counter()
            one = svc.query_range(*q)
            ms = (time.perf_counter() - t) * 1000.0
            total += ms
            if ms > 5000.0:
                log(f"    {name}: {q[0]} over [{q[1]}, {q[3]}]: {ms:.0f} ms")
            if name == "warm":
                fn = dict(QUERIES)[q[0]]
                err = _answers_agree(got, one, fn in ("rate", "increase"))
                errs[fn] = max(errs.get(fn, 0.0), err)
            del one
        runs[f"sequential_{name}"] = {"ms": total,
                                      "launches": dict(_build.LAUNCHES)}
        log(f"  {len(qs)} queries one at a time, {name}: {total:.1f} ms "
            f"({time.perf_counter() - t_run:.1f} s with the checks)")
    del batch
    for name, r in runs.items():
        log(f"  launches, {name.replace('_', ' ')}: {r['launches']}")
    log(f"  every member equal to its single answer (rate and increase bit "
        f"for bit; max abs err by function {errs})")
    return {"queries": len(qs), "shifts": SERVING_SHIFTS, "runs": runs,
            "max_abs_err": errs}


def _scrape_one(store, rng) -> tuple[int, float]:
    """One more sample a series, 10 s after its last, counters going on
    (the series' shards ingest theirs); → (series, seconds)."""
    keys, ts1, vals1 = last_samples(store)
    vals2 = np.where(np.isnan(vals1), 0.0, vals1) \
        + rng.integers(0, 20, len(vals1))
    t = time.perf_counter()
    shard_of = store.shard_of(keys)
    for s, shard in enumerate(store.shards):
        idx = np.flatnonzero(shard_of == s)
        shard.ingest_series([keys[i] for i in idx.tolist()],
                            (ts1[idx] + 10_000)[:, None], vals2[idx, None],
                            np.ones(len(idx), np.int64))
    return len(keys), time.perf_counter() - t


def serving_extents(svc, args) -> dict:
    """Step 2: ``SERVING_QUERY`` over the last 2 h through a service with
    the reference's default ``result_cache`` block: cold, ``SERVING_WARM``
    warm repeats; then two scrapes (a sample a series 10 s after its
    last), each followed by the refresh one step later (only the head
    extent may miss) and the uncached service's query over the same
    range, the refresh first after the first scrape and the uncached
    query first after the second (the first query after a scrape encodes
    the write buffers' pages, which the second finds made). Each cached
    answer is held against the uncached service's over the same data, bit
    for bit (B3, and the same rows in every extent's batch)."""
    import torch

    from filodb_tpu_torch.config import DEFAULTS

    store = svc.memstore
    rng = np.random.default_rng([args.seed, 15])
    cached = smoke_service(store, device=svc.device,
                          result_cache=DEFAULTS["result_cache"])
    rows = []

    def timed(service, s, e):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = service.query_range(SERVING_QUERY, s, 60, e)
        return r, (time.perf_counter() - t) * 1000.0

    def row(what, r, ms, against):
        rows.append({"run": what, "ms": ms, "hits": r.stats.cache_hits,
                     "misses": r.stats.cache_misses,
                     "max_abs_err": _answers_agree(r, against, True)})

    start, end = END_S - 7200, END_S
    want = svc.query_range(SERVING_QUERY, start, 60, end)
    row("cold", *timed(cached, start, end), want)
    cold_bytes = cached.batches.nbytes()
    for i in range(SERVING_WARM):
        row(f"warm {i + 1}", *timed(cached, start, end), want)
    stamped = sum(stamp is not None
                  for stamp, _ in cached.result_cache._lru.values())
    if stamped != 1:
        raise AssertionError(f"phase 15: {stamped} extents carry a version "
                             f"stamp; only the head should")
    scrapes, uncached = [], []
    for k in (1, 2):
        n, secs = _scrape_one(store, rng)
        scrapes.append(secs)
        s, e = start + 60 * k, end + 60 * k
        if k == 1:
            refresh, ms = timed(cached, s, e)
            plain, plain_ms = timed(svc, s, e)
        else:
            plain, plain_ms = timed(svc, s, e)
            refresh, ms = timed(cached, s, e)
        row(f"refresh after scrape {k}", refresh, ms, plain)
        uncached.append(plain_ms)
        if refresh.stats.cache_misses != 1:
            raise AssertionError(f"phase 15: the refresh after scrape {k} "
                                 f"evaluated {refresh.stats.cache_misses} "
                                 f"extents; only the head should miss")
    low, _ = lowered(svc.mesh, SERVING_QUERY, start + 120, end + 120)
    out = {"query": SERVING_QUERY, "extent_steps": cached.result_cache
           .config.extent_steps, "runs": rows, "scrape_series": n,
           "scrape_s": scrapes, "uncached_after_scrape_ms": uncached,
           "cached_batch_bytes_cold": cold_bytes,
           "cached_batch_bytes": cached.batches.nbytes(),
           "uncached_batch_bytes": svc.mesh._batch(store, low).nbytes,
           "result_cache_bytes": cached.result_cache.nbytes}
    for r in rows:
        log(f"  {SERVING_QUERY} {r['run']}: {r['ms']:.1f} ms, extents hit "
            f"{r['hits']}, evaluated {r['misses']}, max abs err "
            f"{r['max_abs_err']} against the uncached answer")
    log(f"  scrapes of {n} series {scrapes} s; the uncached query after "
        f"each {uncached} ms (second, then first after its scrape); "
        f"batches on the card with the extent cache "
        f"{cold_bytes / 1e9:.3f} GB after the cold query (its missing "
        f"extents' one batch), {out['cached_batch_bytes'] / 1e9:.3f} GB "
        f"after the last "
        f"refresh, {out['uncached_batch_bytes'] / 1e9:.3f} GB for the "
        f"uncached query's one batch; extents kept "
        f"{out['result_cache_bytes']} bytes")
    del cached
    return out


def serving_phase(dev, args) -> dict:
    """Phase 15 (see the module's text) on a store of its own."""
    from filodb_tpu_torch import _build

    t = time.perf_counter()
    store = main_store()
    ingest(store, args.serving_series, args.samples, args.seed)
    log(f"phase 15: the serving front end (query_range_many and the extent "
        f"cache); ingest of the first {args.serving_series} series of the "
        f"phase-2 generator {time.perf_counter() - t:.1f} s")
    svc = smoke_service(store, device=dev)
    _build.reset_counts()
    batch = serving_batch(svc)
    launches = {k: sum(r["launches"][k] for r in batch["runs"].values())
                for k in _build.LAUNCHES}
    _build.reset_counts()
    extents = serving_extents(svc, args)
    for k, v in _build.LAUNCHES.items():
        launches[k] += v
    missing = [k for k, v in launches.items() if v == 0]
    if missing and svc.device.type == "cuda":
        raise AssertionError(f"phase 15: kernels not launched: {missing}")
    out = {"batch": batch, "extents": extents, "launches": launches,
           "seconds": time.perf_counter() - t}
    log(f"  launches in phase 15: {launches}; {out['seconds']:.1f} s")
    return out, svc


# phase 16: the query control plane on phase 15's store
CONTROL_QUERY = SERVING_QUERY          # sum(rate) by (_ns_)
CONTROL_THREADS = 16
CONTROL_GOVERNOR = dict(admission_capacity=2, admission_queue_limit=2,
                        max_queue_wait_s=0.5)
# the sidecar site's instants an hour into the 2 h: their 5 m windows
# overlap every series' first (sealed) 400-sample chunk, so the site
# decides (past 4,000 s they reach the write buffers only, which the lane
# folds without a decision)
CONTROL_INSTANT_AT = END_S - 3600
# each query settles one decision a leaf (4 shards): 3 repeats of the 4
# queries settle 48 an arm, past the cost model's min_samples (8)
CONTROL_REPEATS = 3
_APP0_RATE = f'sum(rate({M}{{_ns_="App-0"}}[5m])) by (job)'
ADAPTIVE_BATCHES = (1, 4, 16)
ADAPTIVE_ROUNDS = 3


def _ms(fn) -> tuple:
    t = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t) * 1000.0


def control_plane_phase(svc, args) -> dict:
    """Phase 16 (see the module's text) on phase 15's store."""
    from filodb_tpu_torch import _build
    from filodb_tpu_torch.utils import governor

    t0 = time.perf_counter()
    log("phase 16: the query control plane on phase 15's store")
    _build.reset_counts()
    out = {"window_cache": _control_window_cache(svc, args),
           "governor": _control_governor(svc),
           "cost_model": _control_cost_model(svc, args),
           "adaptive": _control_adaptive(svc),
           "tracing": _control_tracing(svc)}
    governor.reset()
    out["launches"] = dict(_build.LAUNCHES)
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 16: launches {out['launches']}; {out['seconds']:.1f} s")
    return out


def _control_window_cache(svc, args) -> dict:
    """Step 1: a scrape, then the first query misses the window cache on
    the new version and answers bit for bit as a service with
    ``FILODB_MESH_SPLIT=0``."""
    from filodb_tpu_torch.parallel.mesh_engine import _M_EVAL

    start, end = END_S - 7200 + 180, END_S + 180
    svc.query_range(CONTROL_QUERY, start, 60, end)
    _, warm_ms = _ms(lambda: svc.query_range(CONTROL_QUERY, start, 60, end))
    n, scrape_s = _scrape_one(svc.memstore, np.random.default_rng(
        [args.seed, 16]))
    h0, m0 = _M_EVAL["hit"].value, _M_EVAL["miss"].value
    got, first_ms = _ms(lambda: svc.query_range(CONTROL_QUERY, start, 60,
                                                end))
    hits, misses = _M_EVAL["hit"].value - h0, _M_EVAL["miss"].value - m0
    with valves(FILODB_MESH_SPLIT="0"):
        want = smoke_service(svc.memstore, device=svc.device).query_range(
            CONTROL_QUERY, start, 60, end)
    if (hits, misses) != (0, 1):
        raise AssertionError(f"phase 16: after a scrape the window cache "
                             f"hit {hits}, missed {misses}")
    err = _answers_agree(got, want, True)
    entries, nbytes = svc.mesh.window_cache
    out = {"warm_ms": warm_ms, "scrape_series": n, "scrape_s": scrape_s,
           "first_after_scrape_ms": first_ms, "hits": hits,
           "misses": misses, "max_abs_err": err, "entries": entries,
           "device_bytes": nbytes}
    log(f"  window cache under ingest: warm {warm_ms:.1f} ms; a scrape of "
        f"{n} series ({scrape_s:.1f} s); the first query after it "
        f"{first_ms:.1f} ms, a miss on the new version, bit for bit the "
        f"uncached service's; {entries} entries, {nbytes / 1e9:.3f} GB")
    return out


def _control_governor(svc) -> dict:
    """Step 2: admission under load, memory pressure, the deadline, the
    budgets and the default sample limit."""
    import threading

    from filodb_tpu_torch.coordinator.query_service import QueryService
    from filodb_tpu_torch.gateway import influx
    from filodb_tpu_torch.gateway import server as gw
    from filodb_tpu_torch.query.model import QueryContext, QueryLimitExceeded
    from filodb_tpu_torch.utils import governor
    from filodb_tpu_torch.utils.resilience import DeadlineExceeded

    start, end = END_S - 7200, END_S
    out = {}
    # (a) 16 threads against capacity 2 and a queue of 2, the valve off
    governor.reset()
    governor.configure(**CONTROL_GOVERNOR)
    results, barrier = [], threading.Barrier(CONTROL_THREADS)

    def client():
        barrier.wait()
        t = time.perf_counter()
        try:
            r = svc.query_range(CONTROL_QUERY, start, 60, end)
            results.append(("admitted", (time.perf_counter() - t) * 1000.0,
                            r.stats.admission_wait_s))
        except governor.QueryRejected as e:
            results.append((f"shed:{e.reason}", None, None))

    with valves(FILODB_MESH_SPLIT="0"):
        # the batch built first (step 1's scrape moved the store), so the
        # clients wait for each other, not for a re-pack
        svc.query_range(CONTROL_QUERY, start, 60, end)
        threads = [threading.Thread(target=client)
                   for _ in range(CONTROL_THREADS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    admitted = [r for r in results if r[0] == "admitted"]
    queued = [r for r in admitted if r[2] > 1e-3]
    shed = {}
    for r in results:
        if r[0] != "admitted":
            shed[r[0][5:]] = shed.get(r[0][5:], 0) + 1
    out["admission"] = {
        **CONTROL_GOVERNOR, "threads": CONTROL_THREADS,
        "admitted": len(admitted), "queued": len(queued), "shed": shed,
        "admitted_p50_ms": float(np.median([r[1] for r in admitted]))
        if admitted else None,
        "queue_wait_ms": sorted(r[2] * 1000.0 for r in queued)}
    if len(results) != CONTROL_THREADS or len(admitted) < 2 or not shed:
        raise AssertionError(f"phase 16: admission under load: {results}")
    log(f"  admission (capacity 2, queue 2, wait 0.5 s; {CONTROL_THREADS} "
        f"threads, valve off): admitted {len(admitted)} (queued "
        f"{len(queued)}), shed {shed}, admitted p50 "
        f"{out['admission']['admitted_p50_ms']:.1f} ms")
    governor.reset()
    # (b) a watchdog source forced to CRITICAL; the admission classes
    # static (FILODB_ADAPTIVE=0): phase 15 warmed the cost model on this
    # query, whose learned class (CHEAP under 50 ms) would admit it
    wd = governor.MemoryWatchdog(interval_s=999.0)
    level = {"v": 0.99}
    wd.add_source("forced", lambda: level["v"])
    state = wd.sample()
    with valves(FILODB_ADAPTIVE="0"):
        try:
            svc.query_range(CONTROL_QUERY, start, 60, end)
            raise AssertionError("phase 16: a range query was admitted "
                                 "under CRITICAL")
        except governor.QueryRejected as e:
            range_reason = e.reason
        instant = svc.query_instant(CONTROL_QUERY, end)
    sink = gw.ContainerSink({}, num_shards=4, spread=1, flush_every=4,
                            max_pending=4)
    recs = []
    for i in range(6):
        recs += influx.parse_influx_line(
            f"{M},_ws_=demo,_ns_=App-0,instance=x{i} counter={i}",
            {"_ws_": "demo", "_ns_": "App-0"}, now_ms=END_S * 1000)
    sink._pending.records.extend(recs[:4])  # full, a drain in flight
    sink._flushing = True
    shed0 = gw.records_shed.value
    sink.add(recs[4:])
    level["v"] = 0.1
    back = wd.sample()
    again = svc.query_range(CONTROL_QUERY, start, 60, end)
    out["critical"] = {"state": state, "range": f"shed:{range_reason}",
                       "instant_rows": instant.result.num_series,
                       "gateway_records_shed": gw.records_shed.value - shed0,
                       "after": back,
                       "range_after_rows": again.result.num_series}
    if state != governor.CRITICAL or range_reason != "critical" \
            or not instant.result.num_series \
            or out["critical"]["gateway_records_shed"] != 2 \
            or back != governor.OK:
        raise AssertionError(f"phase 16: CRITICAL: {out['critical']}")
    log(f"  CRITICAL: the range query shed ({range_reason}), the instant "
        f"admitted ({instant.result.num_series} rows), gateway records shed "
        f"{out['critical']['gateway_records_shed']}; back to {back}, the "
        f"range query admitted")
    # (c) a deadline of 1 ms, the valve off
    with valves(FILODB_MESH_SPLIT="0"):
        try:
            smoke_service(svc.memstore, device=svc.device,
                          query_timeout_s=0.001).query_range(
                CONTROL_QUERY, start, 60, end)
            raise AssertionError("phase 16: a 1 ms deadline passed")
        except DeadlineExceeded as e:
            out["deadline"] = str(e)
    log(f"  query_timeout_s 1 ms: DeadlineExceeded ({out['deadline']})")
    # (d) the samples budget on the exec engine, partial then error
    ex = smoke_service(svc.memstore, device=svc.device, engine="exec")
    full = ex.query_range(CONTROL_QUERY, start, 60, end)
    budget = {}
    for degrade in ("partial", "error"):
        qc = wide()
        qc.planner_params.budget = governor.QueryBudget(
            max_samples_scanned=100_000, degrade=degrade)
        try:
            r = ex.query_range(CONTROL_QUERY, start, 60, end, qc)
            budget[degrade] = {"partial": r.partial,
                               "warnings": r.warnings,
                               "rows": r.result.num_series}
        except governor.QueryBudgetExceeded as e:
            budget[degrade] = {"raised": str(e)}
    if not budget["partial"].get("partial") \
            or not budget["partial"]["warnings"] \
            or "raised" not in budget["error"]:
        raise AssertionError(f"phase 16: the samples budget: {budget}")
    out["budget"] = {**budget, "full_samples_scanned":
                     full.stats.samples_scanned}
    whole = full.stats.samples_scanned
    log(f"  max_samples_scanned 100,000 on exec ({whole} scanned whole): "
        f"partial with {len(budget['partial']['warnings'])} warnings "
        f"({budget['partial']['warnings'][0]}), "
        f"{budget['partial']['rows']} rows; error: "
        f"{budget['error']['raised']}")
    # (e) the default sample limit on a per-series increase (121 steps
    # over more than 8,264 series pass 1,000,000 samples)
    plain = QueryService(svc.memstore, device=svc.device,
                         query_timeout_s=SMOKE_TIMEOUT_S)
    series = sum(sh.num_partitions for sh in svc.memstore.shards)
    try:
        r = plain.query_range(f"increase({M}[5m])", start, 60, end,
                              QueryContext())
        out["sample_limit"] = f"{r.result.num_series} x 121 samples pass"
        if series * 121 > 1_000_000:
            raise AssertionError("phase 16: the default sample limit passed")
    except QueryLimitExceeded as e:
        out["sample_limit"] = str(e)
    log(f"  the default sample limit: {out['sample_limit']}")
    return out


def _control_cost_model(svc, args) -> dict:
    """Step 3: ``SIDECAR_INSTANT`` through the sidecar site: at the
    static arm (the geometry gate), with the fold forced
    (``FILODB_SIDECAR_SEALED_GATE=0``, the override), then the model's
    pick once both arms are warm; persisted and installed again through
    a local meta store."""
    from filodb_tpu_torch.coordinator import adaptive_planner
    from filodb_tpu_torch.core.store.localstore import LocalDiskMetaStore
    from filodb_tpu_torch.query import cost_model as cm

    ds = svc.memstore.dataset
    model = cm.model_for(ds)
    at = CONTROL_INSTANT_AT
    runs = []
    for label, env in (("static", {}),
                       ("forced fold", {"FILODB_SIDECAR_SEALED_GATE": "0"}),
                       ("model", {})):
        for q in SIDECAR_INSTANT:
            d0 = {src: cm._decided[("sidecar", src)].value
                  for src in ("static", "model", "override")}
            ms, arms = [], []
            with valves(**env):
                for _ in range(CONTROL_REPEATS):
                    r, t = _ms(lambda: svc.query_instant(q, at))
                    ms.append(t)
                    arms.append("decode" if r.stats.sidecar_bypassed
                                else "sidecar")
            runs.append({"run": label, "query": q,
                         "warm_p50_ms": float(np.median(ms[1:])),
                         "ms": ms,
                         "cold_ms": ms[0], "arms": arms,
                         "decisions": {src: cm._decided[("sidecar", src)]
                                       .value - v for src, v in d0.items()}})
            log(f"  sidecar site [{label}] {q}: warm p50 "
                f"{runs[-1]['warm_p50_ms']:.1f} ms, arms {arms}, decisions "
                f"{runs[-1]['decisions']}")
    root = tempfile.mkdtemp(prefix="filodb-costmodel-")
    try:
        meta = LocalDiskMetaStore(root)
        before = model.to_bytes()
        adaptive_planner.persist(ds, meta)
        cm.reset_models()
        again = adaptive_planner.install(ds, meta, {})
        same = again.to_bytes() == before
        meta.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if not same:
        raise AssertionError("phase 16: the cost model's estimates changed "
                             "through persist and install")
    if not any(r["decisions"]["model"] for r in runs):
        raise AssertionError("phase 16: the sidecar site never left its "
                             "static arm's source")
    ests = [r for r in again.snapshot()["estimates"]
            if r["site"] == "sidecar"]
    log(f"  persisted and installed through a local meta store: estimates "
        f"equal ({len(ests)} sidecar rows)")
    return {"at_s": at, "runs": runs, "estimates": ests,
            "persisted_equal": same}


def _control_adaptive(svc) -> dict:
    """Step 4: ``engine="adaptive"``: ``query_range_many`` batches of 1, 4
    and 16 over App-0, repeated; every answer equal to the mesh engine's
    (the host lane's within rtol 2e-5, atol 1e-6)."""
    ad = smoke_service(svc.memstore, device=svc.device, engine="adaptive")
    rows = []
    for rnd in range(ADAPTIVE_ROUNDS):
        for n in ADAPTIVE_BATCHES:
            qs = [(_APP0_RATE, END_S - 7200 - 60 * (i % 5), 60,
                   END_S - 60 * (i % 5)) for i in range(n)]
            before = dict(ad.mesh.routed)
            got, ms = _ms(lambda: ad.query_range_many(qs))
            want = svc.query_range_many(qs)
            lane = [k for k, v in ad.mesh.routed.items()
                    if v > before[k]]
            # the device lane is the mesh engine: bit for bit
            err = max(_answers_agree(g, w, lane == ["device"])
                      for g, w in zip(got, want))
            rows.append({"round": rnd, "batch": n, "ms": ms, "lane": lane,
                         "max_abs_err": err})
    ad.mesh.drain()
    out = {"runs": rows, "routed": dict(ad.mesh.routed),
           "shadowed": dict(ad.mesh.shadowed),
           "estimates_s_per_query": {
               lane: {str(b): v for b, v in e.items()}
               for lane, e in ad.mesh.estimates().items()},
           "sync_floor_ms": (ad.mesh.sync_floor_s or 0.0) * 1000.0}
    log(f"  adaptive: routed {out['routed']}, shadowed {out['shadowed']}, "
        f"estimates {out['estimates_s_per_query']}, sync floor "
        f"{out['sync_floor_ms']:.3f} ms; every answer equal to mesh's")
    for r in rows:
        log(f"    round {r['round']} batch {r['batch']}: {r['ms']:.1f} ms "
            f"on {r['lane']}")
    return out


def _control_tracing(svc) -> dict:
    """Step 5: one query traced at ``sample_rate`` 1; with a threshold of
    1 ms it lands in the slow-query ring with its span tree."""
    from filodb_tpu_torch.utils import tracing

    tracing.configure(sample_rate=1.0, slow_query_threshold_ms=1.0)
    tracing.flight_recorder().clear()
    try:
        fresh = smoke_service(svc.memstore, device=svc.device)
        r = fresh.query_range(CONTROL_QUERY, END_S - 7200, 60, END_S)
        entries = tracing.slow_queries()
    finally:
        tracing.configure()
    if not entries or entries[0]["query"] != CONTROL_QUERY \
            or not entries[0]["spans"]:
        raise AssertionError(f"phase 16: the traced query is not in the "
                             f"slow-query ring: {entries}")
    spans = [(s["name"], s["depth"], s["duration_ms"])
             for s in entries[0]["spans"]]
    log(f"  traced {CONTROL_QUERY} ({r.stats.wall_time_s * 1000.0:.1f} ms) "
        f"in the slow-query ring: " + ", ".join(
            f"{'  ' * d}{n} {ms:.1f} ms" for n, d, ms in spans))
    return {"duration_ms": entries[0]["duration_ms"], "spans": spans}


# The smoke is a caller of the reference's kind: its per-series shapes
# answer up to 121 M samples (phase 3's increase over 1 M series), past
# the default result-sample limit of 1,000,000, so its queries carry a
# QueryContext whose PlannerParams raise the limit (``wide``), as a caller
# of the reference raises it; phase 16 checks that the default raises.
# Its deadline is SMOKE_TIMEOUT_S: a cold query at 1 M series takes up to
# 40 s, past the default 30 s.
# phase 17: the write path on phase 17's store (CORE_SERIES series; the
# phase-2 store under --ingest-only). A scrape a
# container lane: CORE_SCRAPES scrapes of every series 10 s apart from the
# 2 h's end, each shard's series in containers of CORE_CONTAINER records
# (the gateway's flush_every), one ingest thread a shard, as the node's
# ingest workers run; the buffers of CORE_CHECKED series held against what
# was sent; a query and the sidecar instants over the new samples; and
# the seal wave that 400-sample chunks give every series every 4,000 s
CORE_SCRAPES = 12
# the series of phases 17 and 20 in the full smoke (1 M until phase 21
# came; the phase-2 store under --ingest-only and --rules-only; PERF.md §4)
CORE_SERIES = 250_000
CORE_CONTAINER = 512
CORE_CHECKED = 1_000
CORE_QUERY = f"sum(rate({M}[5m])) by (_ns_)"
CORE_BUDGET_S = 120.0  # the phase's share of the smoke's limit


def scrape_templates(store) -> list[dict]:
    """Per shard: its keys in pid order, and one container of
    ``CORE_CONTAINER`` records after another, serialized into one numpy
    buffer whose timestamp and value fields each scrape patches in place,
    with the byte offsets of those fields and each container's [start,
    end). ``MemStore.shard_of`` routes every series to the shard that
    holds it (as the gateway's ``ContainerSink`` routes)."""
    import struct

    from filodb_tpu_torch.core.record import encode_labels
    from filodb_tpu_torch.core.schemas import SCHEMAS

    keys = [list(shard.keys) for shard in store.shards]
    routed = store.shard_of([k for ks in keys for k in ks])
    at, out = 0, []
    for s, (shard, ks) in enumerate(zip(store.shards, keys)):
        if (routed[at:at + len(ks)] != s).any():
            raise AssertionError(f"phase 17: shard_of routes a series of "
                                 f"shard {s} elsewhere")
        at += len(ks)
        hashes = shard.hashes[:len(ks)].tolist()
        parts, ts_off, val_off, spans, pos = [], [], [], [], 0
        for a in range(0, len(ks), CORE_CONTAINER):
            chunk = ks[a:a + CORE_CONTAINER]
            parts.append(struct.pack("<BI", 2, len(chunk)))
            start, pos = pos, pos + 5
            for k, h in zip(chunk, hashes[a:a + CORE_CONTAINER]):
                lab = encode_labels(k.labels)
                n = 14 + len(lab) + 10  # header, labels, one double value
                parts += [struct.pack("<IIqH", n, h, 0,
                                      SCHEMAS[k.schema].schema_id), lab,
                          b"\x01\x00" + bytes(8)]
                ts_off.append(pos + 8)
                pos += 4 + n
                val_off.append(pos - 8)
            spans.append((start, pos))
        out.append(dict(keys=ks, buf=np.frombuffer(bytearray(b"".join(
            parts)), np.uint8), ts_off=np.array(ts_off, np.int64),
            val_off=np.array(val_off, np.int64), spans=spans))
    return out


def _patch(buf: np.ndarray, off: np.ndarray, x: np.ndarray) -> None:
    """Write 8-byte ``x[i]`` at byte ``off[i]`` of ``buf``."""
    buf[off[:, None] + np.arange(8)] = np.ascontiguousarray(x).view(
        np.uint8).reshape(-1, 8)


def _scrape(shard, t: dict, first_offset: int) -> tuple[int, float]:
    """One shard's containers of one scrape through ``Shard.ingest`` at
    consecutive offsets; (samples kept, seconds)."""
    from filodb_tpu_torch.core.record import BytesContainer, SomeData

    t0 = time.perf_counter()
    kept = 0
    for i, (a, b) in enumerate(t["spans"]):
        kept += shard.ingest(SomeData(BytesContainer(bytes(t["buf"][a:b])),
                                      first_offset + i))
    return kept, time.perf_counter() - t0


def lane_split(svc, end: int) -> dict:
    """Where a warm sidecar instant at ``end`` spends its time (the lane
    forced): the write-buffer fold alone, a shard at a time over all its
    series (``native_shard.buf_fold``, one 5 m window), and the host's
    largest self times and the device's largest kernels over the whole
    query."""
    from filodb_tpu_torch.core.memstore.native_shard import buf_fold

    q = SIDECAR_INSTANT[3]
    fold = []
    for shard in svc.memstore.shards:
        pids = np.arange(shard.num_partitions)
        t = np.array([end * 1000], np.int64)
        with shard.lock:
            fold.append(wall_ms(lambda: buf_fold(
                shard.buffers, pids, t - 300_000, t, shard._sealed.columns,
                shard.num_partitions)))
    with valves(FILODB_SIDECAR_SEALED_GATE="0"):
        run = lambda: svc.query_instant(q, end).result.materialize()
        out = {"query": q, "fold_ms_shard": fold,
               "host_ms": host_split(run, 3, 15),
               "device": top_device_ops(run, 3)}
    log(f"  the lane's split ({q}): buffer fold a shard "
        f"{', '.join(f'{x:.1f}' for x in fold)} ms; host self ms "
        f"{json.dumps(out['host_ms'])}; device {json.dumps(out['device'])}")
    return out


def ingest_core_phase(svc, args, keep: dict | None = None) -> dict:
    """Phase 17: scrapes through the C++ ingest core at full width, the
    buffers checked, a query and the sidecar instants over them, then the
    seal wave. ``keep`` (a dict) gets the container templates and each
    shard's last counter values, from which phase 20 scrapes on."""
    from concurrent.futures import ThreadPoolExecutor

    from filodb_tpu_torch import _build

    t_phase = time.perf_counter()
    store = svc.memstore
    t = time.perf_counter()
    temps = scrape_templates(store)
    build_s = time.perf_counter() - t
    n_series = sum(len(x["keys"]) for x in temps)
    nbytes = sum(len(x["buf"]) for x in temps)
    log(f"phase 17: the write path through the C++ ingest core, "
        f"{n_series} series: container templates {build_s:.1f} s "
        f"({sum(len(x['spans']) for x in temps)} containers of "
        f"{CORE_CONTAINER} records, {nbytes / n_series:.0f} bytes a record)")
    # what each scrape sends: each series' counter from its last buffered
    # sample on, at END + 10 s k with the generator's jitter
    rng = np.random.default_rng(args.seed + 17)
    sent = []
    for shard, x in zip(store.shards, temps):
        P = len(x["keys"])
        rows = shard.buffers.slot[:P]
        last = shard.buffers.vals[rows, shard.buffers.n[rows] - 1]
        ts = (END_S * 1000 + np.arange(CORE_SCRAPES)[:, None] * 10_000
              + rng.integers(-500, 501, (CORE_SCRAPES, P)))
        vals = last[None, :] + np.cumsum(rng.integers(
            0, 20, (CORE_SCRAPES, P)), axis=0).astype(np.float64)
        sent.append((ts, vals, shard.buffers.n[rows].copy()))
    _build.reset_counts()
    wall, busy, kept = [], np.zeros(len(temps)), 0
    with ThreadPoolExecutor(len(temps)) as pool:
        for k in range(CORE_SCRAPES):
            for x, (ts, vals, _) in zip(temps, sent):
                _patch(x["buf"], x["ts_off"], ts[k])
                _patch(x["buf"], x["val_off"], vals[k])
            t = time.perf_counter()
            done = list(pool.map(
                lambda sx: _scrape(sx[0], sx[1], k * len(sx[1]["spans"])),
                zip(store.shards, temps)))
            wall.append(time.perf_counter() - t)
            busy += [s for _, s in done]
            kept += sum(n for n, _ in done)
    if kept != CORE_SCRAPES * n_series:
        raise AssertionError(f"phase 17: {kept} samples kept of "
                             f"{CORE_SCRAPES * n_series} sent")
    if keep is not None:
        keep.update(temps=temps, last=[v[-1] for _, v, _ in sent])
    out = {"series": n_series, "scrapes": CORE_SCRAPES,
           "container_records": CORE_CONTAINER, "template_s": build_s,
           "rows": kept, "rows_per_s": kept / sum(wall),
           "rows_per_s_shard": [CORE_SCRAPES * len(x["keys"]) / b
                                for x, b in zip(temps, busy)],
           "scrape_s": wall, "scrape_p50_s": float(np.median(wall)),
           "scrape_max_s": max(wall)}
    log(f"  {CORE_SCRAPES} scrapes: {kept} samples, "
        f"{out['rows_per_s']:.0f} rows/s on the node, a shard "
        f"{', '.join(f'{r:.0f}' for r in out['rows_per_s_shard'])} rows/s; "
        f"a scrape p50 {out['scrape_p50_s']:.2f} s, max "
        f"{out['scrape_max_s']:.2f} s")

    # the buffers of sampled series against what was sent
    pick = np.random.default_rng(args.seed + 18)
    for _ in range(CORE_CHECKED):
        s = int(pick.integers(len(temps)))
        shard, x = store.shards[s], temps[s]
        p = int(pick.integers(len(x["keys"])))
        ts, vals, n0 = sent[s]
        row = shard.buffers.slot[p]
        n = int(shard.buffers.n[row])
        inst = int(x["keys"][p].label_map["instance"].split("-")[1])
        want = {"_metric_": M, "_ws_": "demo", "_ns_": f"App-{inst % 100}",
                "instance": f"instance-{inst}", "job": f"job-{inst % 10}"}
        if shard.keys[p].label_map != want \
                or shard.lookup_keys([x["keys"][p].serialized])[0] != p \
                or n != n0[p] + CORE_SCRAPES \
                or not np.array_equal(shard.buffers.ts[row, n - CORE_SCRAPES:n],
                                      ts[:, p]) \
                or not np.array_equal(shard.buffers.vals[row,
                                                         n - CORE_SCRAPES:n],
                                      vals[:, p]) \
                or shard.latest[p] != ts[-1, p]:
            raise AssertionError(f"phase 17: shard {s} pid {p}: its key, "
                                 f"buffer or latest is not what was sent")
    out["checked"] = CORE_CHECKED
    log(f"  {CORE_CHECKED} sampled series: key, map, buffer rows and "
        f"latest equal to what was sent")

    # the new samples through the main path and the sidecar lane
    end = int(max(ts.max() for ts, _, _ in sent)) // 1000 + 1
    start = end - 600
    t = time.perf_counter()
    r = on_mesh(svc.query_range(CORE_QUERY, start, 60, end), CORE_QUERY)
    out["query_cold_ms"] = (time.perf_counter() - t) * 1000.0
    if r.result.values.shape != (min(100, n_series), 11) \
            or not np.isfinite(r.result.values).all():
        raise AssertionError(f"phase 17: {CORE_QUERY}: shape "
                             f"{r.result.values.shape}")
    launches = dict(_build.LAUNCHES)
    if svc.device.type == "cuda" and not launches["fused_decode_rate"]:
        raise AssertionError("phase 17: B3 did not launch")
    if svc.device.type == "cuda":
        out["query_vs_plain"] = rate_against_plain(svc, CORE_QUERY, start,
                                                   end, r.result)
    log(f"  {CORE_QUERY} over the last 10 min: cold "
        f"{out['query_cold_ms']:.1f} ms, equal to the plain path "
        f"({out.get('query_vs_plain')})")
    _build.reset_counts()  # the comparison's launches do not count
    out["sidecar_instants"] = sidecar_instants(svc, end)
    out["launches"] = {k: launches[k] + _build.LAUNCHES[k] for k in launches}
    out["lane_split"] = lane_split(svc, end)

    # the seal wave
    t = time.perf_counter()
    before = sum(len(sh.chunks["pid"]) for sh in store.shards)
    with ThreadPoolExecutor(len(temps)) as pool:
        list(pool.map(lambda sh: sh.seal(np.arange(sh.num_partitions)),
                      store.shards))
    out["seal_s"] = time.perf_counter() - t
    out["seal_chunks"] = sum(len(sh.chunks["pid"]) for sh in store.shards) \
        - before
    if out["seal_chunks"] != n_series:
        raise AssertionError(f"phase 17: the seal wave made "
                             f"{out['seal_chunks']} chunks for {n_series} "
                             f"series")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  seal wave: {out['seal_chunks']} chunks in {out['seal_s']:.1f} "
        f"s; launches in the phase {out['launches']}; phase 17 took "
        f"{out['seconds']:.1f} s (its share {CORE_BUDGET_S:.0f} s)")
    return out


WIDE_LIMIT = 1 << 40
SMOKE_TIMEOUT_S = 900.0
_SMOKE_SERVICE = []


# phase 18: long retention. A store of its own on the local disk, built
# from the phase-2 generator's counters and phase 14's load averages (a
# quarter as many), LT_SAMPLES samples at 10 s (6 h), flushed; the
# downsampler job over it at the reference's resolutions; then queries over
# the 6 h through LongTimeRangePlanner and TieredPlanner, ``now`` pinned to
# the data's end, the raw retention LT_RAW_RETENTION_MS and the memory's
# LT_MEM_RETENTION_MS: the downsample tier serves the first 4 h, the cold
# raw tier the next hour, the memstore the last. It models a node of 1 M
# series with 3 days of raw retention (``filodb_tpu/config.py``); the
# series, the history and both retentions are cut (PERF.md §4), the widths
# are not: the 10 s scrape, the 5 m and 1 h resolutions, the label sets.
LT_DS = "timeseries"
LT_SAMPLES = 2160               # 6 h at 10 s
LT_SERIES = 2_500               # counters in the full smoke (PERF.md §4)
LT_SERIES_ALONE = 100_000       # counters under --longterm-only
LT_GAUGES = 4                   # counters a load-average series
LT_RESOLUTIONS = (300_000, 3_600_000)
LT_RAW_RETENTION_MS = 2 * 3_600_000
LT_MEM_RETENTION_MS = 3_600_000
LT_ODP_CHUNKS = 2_000_000       # the tiers' ODP caches hold the 6 h
LT_QUERIES = (f"sum(rate({M}[15m])) by (_ns_)",
              f"sum(sum_over_time({LOAD1}[15m])) by (job)",
              f"avg(avg_over_time({LOAD1}[15m]))",
              f"max(max_over_time({LOAD1}[15m])) by (_ns_)")
LT_WARM = 3
LT_SUBSET = '_ns_="App-0"'
LT_TOL = dict(rtol=2e-5, atol=1e-6, equal_nan=True)


def _lt_subset(q: str) -> str:
    for m in (M, LOAD1):
        q = q.replace(f"{m}[", f"{m}{{{LT_SUBSET}}}[")
    return q


def _lt_planners(store, now_ms: int) -> dict:
    """A long-time and a tiered planner over ``store`` and its column
    store, each with stores of its own (their cold runs page in)."""
    from filodb_tpu_torch.coordinator.longtime_planner import (
        LongTimeRangePlanner,
    )
    from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
    from filodb_tpu_torch.coordinator.tiered_planner import (
        build_tiered_planner,
    )
    from filodb_tpu_torch.core.downsample import DownsampledTimeSeriesStore

    def ds_planner():
        return SingleClusterPlanner(4, 1, store=DownsampledTimeSeriesStore(
            store.column_store, LT_DS, LT_RESOLUTIONS[0], 4,
            max_chunks=LT_ODP_CHUNKS))

    return {
        "longtime": LongTimeRangePlanner(
            SingleClusterPlanner(4, 1), ds_planner(), LT_RAW_RETENTION_MS,
            now_ms=lambda: now_ms),
        "tiered": build_tiered_planner(
            SingleClusterPlanner(4, 1), store.column_store, LT_DS, 4, 1,
            mem_retention_ms=LT_MEM_RETENTION_MS,
            raw_retention_ms=LT_RAW_RETENTION_MS, ds_planner=ds_planner(),
            odp_max_chunks=LT_ODP_CHUNKS, now_ms=lambda: now_ms)}


def _lt_paged(planner) -> tuple:
    """(chunks paged, bytes read) by the ODP caches of the planner's
    colder tiers."""
    stores = [p.store for p in (getattr(planner, "cold_planner", None),
                                planner.ds_planner) if p is not None]
    return (sum(s.odp_cache.chunks_paged for st in stores
                for s in st.shards),
            sum(s.odp_cache.bytes_read for st in stores for s in st.shards))


def _lt_tier_answers(svc, planner, q: str, start: int, end: int):
    """The tiered planner's per-tier answers of ``q``, each over its own
    step range: [(tier, answer)]."""
    from filodb_tpu_torch.coordinator.longtime_planner import (
        rewrite_for_downsample,
    )
    from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query
    from filodb_tpu_torch.query import logical as lp
    from filodb_tpu_torch.query.federation import (
        DOWNSAMPLE,
        OBJECTSTORE,
        route_tiers,
    )

    plan = parse_query(q, TimeStepParams(start, 60, end))
    a, step, b, lookback = lp.plan_times(plan)
    mem_floor, raw_floor = planner._floors()
    out = []
    for r in route_tiers(a, step, b, lookback, mem_floor, raw_floor):
        sub = lp.retime(plan, r.start, step, r.end)
        tier_planner = {OBJECTSTORE: planner.cold_planner,
                        DOWNSAMPLE: planner.ds_planner}.get(
                            r.tier, planner.raw_planner)
        if r.tier == DOWNSAMPLE:
            sub = rewrite_for_downsample(sub)
        saved, svc.planner = svc.planner, tier_planner
        try:
            out.append((r.tier, svc.execute_logical(sub, wide())))
        finally:
            svc.planner = saved
    return out


def _lt_stitched_check(full, parts) -> int:
    """The stitched answer at each tier's steps equals that tier's own
    answer (rows by key, rtol 1e-9); → the steps checked."""
    fk, fv = _sorted_answer(full)
    steps = np.asarray(full.result.steps_ms)
    n = 0
    for tier, res in parts:
        k, v = _sorted_answer(res)
        at = np.searchsorted(steps, np.asarray(res.result.steps_ms))
        rows = [fk.index(x) for x in k]
        got = fv[rows][:, at]
        if not np.allclose(got, v, rtol=1e-9, atol=1e-12, equal_nan=True):
            raise AssertionError(f"phase 18: the stitched answer is not the "
                                 f"{tier} tier's own over its steps")
        n += len(at)
    if n != len(steps):
        raise AssertionError(f"phase 18: the tiers' steps ({n}) are not the "
                             f"query's ({len(steps)})")
    return n


def _lt_node_config(root: str, gateway: int) -> str:
    path = Path(root) / "server.json"
    path.write_text(json.dumps({
        "node_name": "node-0", "data_dir": root, "http_port": 0,
        "gateway_port": gateway,
        "datasets": {LT_DS: {
            "num_shards": 4, "spread": 1, "engine": "mesh",
            "store": {"max_chunk_size": 400, "groups_per_shard": 20,
                      "flush_interval_ms": 6_000_000,
                      "retention_ms": NODE_RETENTION_MS},
            "downsample": {"resolutions_ms": list(LT_RESOLUTIONS),
                           "streaming": True, "schedule_s": 21_600,
                           "raw_retention_ms": LT_RAW_RETENTION_MS}}},
        "federation": {"mem_retention_ms": LT_MEM_RETENTION_MS,
                       "odp_max_chunks": LT_ODP_CHUNKS},
        # the cold federated query at 125,000 series outlasts the
        # default 30 s deadline (the smoke's own, as its services')
        "resilience": {"query_timeout_s": SMOKE_TIMEOUT_S}}))
    return str(path)


def _lt_node(dev, root: str, now_ms: int, tiered_answer,
             series: int) -> dict:
    """Step 4: a node over the directory with streaming downsampling and
    federation: its tier status, a three-tier query over HTTP with
    ``?stats=all``, then a new hour of App-0's counters, flushed (the
    rollups published), a scheduler tick's ds flushes, and a ds query
    that sees the new rollups."""
    import socket

    from filodb_tpu_torch.config import ServerConfig
    from filodb_tpu_torch.coordinator.tiered_planner import TieredPlanner
    from filodb_tpu_torch.core.downsample import ds_dataset_name
    from filodb_tpu_torch.standalone import FiloServer

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        gateway = sock.getsockname()[1]
    t = time.perf_counter()
    srv = FiloServer(ServerConfig.load(_lt_node_config(root, gateway)),
                     device=dev).start()
    try:
        if not srv.cluster.wait_active(LT_DS, timeout=900):
            raise AssertionError("phase 18: the node's shards are not "
                                 "ACTIVE")
        out = {"boot_s": time.perf_counter() - t}
        svc = srv.services[LT_DS]
        if not isinstance(svc.planner, TieredPlanner):
            raise AssertionError(f"phase 18: the node's planner is "
                                 f"{type(svc.planner).__name__}")
        svc.planner.now_ms = lambda: now_ms
        code, body, ms = http_get(srv.http.port, "/api/v1/status/tiers")
        doc = json.loads(body)["data"][LT_DS]
        if code != 200 or not doc["federated"] or [
                x["tier"] for x in doc["tiers"]] != [
                    "objectstore", "downsample", "memstore"]:
            raise AssertionError(f"phase 18: status/tiers: {code} {body}")
        out["status_tiers"] = doc
        q = LT_QUERIES[0]
        end = now_ms // 1000
        code, body, cold = http_get(
            srv.http.port, f"/promql/{LT_DS}/api/v1/query_range", query=q,
            start=end - 6 * 3600, step=60, end=end, stats="all")
        got = json.loads(body)
        if code != 200 or set(got["queryStats"]["tiers"]) != {
                "memstore", "objectstore", "downsample"}:
            raise AssertionError(f"phase 18: the node's federated query: "
                                 f"{code} {body[:300]}")
        m = tiered_answer.result.materialize()
        want = {tuple(sorted(k.labels)): np.asarray(v)
                for k, v in zip(m.keys, np.asarray(m.values))}
        steps = np.asarray(m.steps_ms) / 1000.0
        if len(got["data"]["result"]) != len(want):
            raise AssertionError("phase 18: the node's answer has other "
                                 "series than the in-process one")
        for r in got["data"]["result"]:
            w = want[tuple(sorted(r["metric"].items()))]
            fin = np.isfinite(w)
            g = np.array([float(x) for _, x in r["values"]])
            if [float(t) for t, _ in r["values"]] != steps[fin].tolist() \
                    or not np.allclose(g, w[fin], rtol=2e-5, atol=1e-6):
                raise AssertionError(f"phase 18: the node's answer for "
                                     f"{r['metric']} is not the in-process "
                                     f"one")
        out["http"] = {"query": q, "cold_ms": cold,
                       "tiers": got["queryStats"]["tiers"]}
        log(f"  node: booted in {out['boot_s']:.1f} s, tiers "
            f"{[x['tier'] for x in doc['tiers']]}; {q} over HTTP cold "
            f"{cold:.1f} ms, equal to the in-process tiered answer")
        # streaming: an hour more of App-0's counters, flushed
        raw = srv.node.memstores[LT_DS]
        rng = np.random.default_rng(18)
        labels = [{"_metric_": M, "_ws_": "demo", "_ns_": "App-0",
                   "instance": f"instance-{i}", "job": f"job-{i % 10}"}
                  for i in range(0, series, 100)]  # phase 2's App-0
        n_new = 360
        ts = now_ms + 10_000 * (1 + np.arange(n_new, dtype=np.int64))
        base = np.full((len(labels), 1), 1e6)
        vals = base + np.cumsum(rng.integers(0, 20, (len(labels), n_new)),
                                axis=1)
        raw.ingest_series(labels, np.tile(ts, (len(labels), 1)), vals)
        ds_name = ds_dataset_name(LT_DS, LT_RESOLUTIONS[0])
        ds_store = srv.node.memstores[ds_name]
        probe = smoke_service(ds_store, device=dev, engine="exec")
        qd = f"sum(rate({M}{{{LT_SUBSET}}}[15m]))"
        new_end = (ts[-1] // 1000) + 60
        new_start = now_ms // 1000 + 1200
        before = probe.query_range(qd, new_start, 60, new_end)
        t = time.perf_counter()
        flushed = sum(sh.flush_all() for sh in raw.shards)
        records = sum(sh.stats.downsample_records.value for sh in raw.shards)
        ticks = 0
        for key in list(srv.node._ds_shards):
            for _ in range(20):
                srv.node._flusher.flush_ds(key)
                ticks += 1
        after = probe.query_range(qd, new_start, 60, new_end)
        vals_after = np.asarray(after.result.materialize().values)
        if np.isfinite(np.asarray(before.result.materialize().values)).any() \
                or not np.isfinite(vals_after).any():
            raise AssertionError("phase 18: the ds query does not see the "
                                 "new rollups")
        out["streaming"] = {"series": len(labels), "samples": n_new,
                            "raw_chunks_flushed": flushed,
                            "rollup_records": records,
                            "ds_flushes": ticks,
                            "seconds": time.perf_counter() - t,
                            "ds_steps_answered": int(np.isfinite(
                                vals_after).sum())}
        log(f"  streaming: {len(labels)} series x {n_new} new samples "
            f"flushed ({flushed} chunks), {records} rollup records "
            f"published, {ticks} ds flushes; the ds query answers "
            f"{out['streaming']['ds_steps_answered']} new steps")
        return out
    finally:
        srv.shutdown()


def longterm_phase(dev, args) -> dict:
    """Phase 18: long retention (see the module)."""
    from filodb_tpu_torch import _build
    from filodb_tpu_torch.core.downsample import DownsamplerJob

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="filodb-longterm-")
    try:
        out = _longterm(dev, args, root, _build, DownsamplerJob)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 18 took {out['seconds']:.1f} s")
    return out


def _longterm(dev, args, root: str, _build, DownsamplerJob) -> dict:
    series = args.longterm_series
    gauges = series // LT_GAUGES
    store = durable_store(root, LT_DS, retention_ms=NODE_RETENTION_MS,
                          max_query_matches=0)
    t = time.perf_counter()
    rng = np.random.default_rng(args.seed + 18)
    kept = 0
    for a in range(0, series, 65536):
        kept += store.ingest_series(*make_series(
            rng, a, min(a + 65536, series), LT_SAMPLES))
    for a in range(0, gauges, 65536):
        labels, ts, vals = make_host_series(rng, LOAD1, a,
                                            min(a + 65536, gauges),
                                            LT_SAMPLES)
        kept += store.ingest_series(labels, ts, vals, schema="gauge")
    ingest_s = time.perf_counter() - t
    t = time.perf_counter()
    chunks = store.flush_all()
    flush_s = time.perf_counter() - t
    raw_bytes = dir_bytes(Path(root) / "columnstore" / LT_DS)
    now_ms = T0_MS + LT_SAMPLES * 10_000
    log(f"phase 18: long retention: {series} counters and {gauges} load "
        f"averages x {LT_SAMPLES} samples (6 h), {kept} kept, ingested in "
        f"{ingest_s:.1f} s, flushed in {flush_s:.1f} s ({chunks} chunks, "
        f"{raw_bytes / 1e6:.1f} MB of sqlite)")
    out = {"counters": series, "gauges": gauges, "samples": LT_SAMPLES,
           "ingest_s": ingest_s, "flush_s": flush_s, "raw_chunks": chunks,
           "raw_bytes": raw_bytes}
    # 1. the batch job, then a second catch-up that finds nothing
    job = DownsamplerJob(store.column_store, LT_DS, 4, LT_RESOLUTIONS,
                         max_chunk_size=400, meta_store=store.meta_store)
    t = time.perf_counter()
    stats = job.catch_up(int(time.time() * 1000))
    job_s = time.perf_counter() - t
    again = job.catch_up(int(time.time() * 1000))
    if again["raw_chunks"] or again["ds_samples"] or not stats["ds_chunks"]:
        raise AssertionError(f"phase 18: the job's checkpoint does not hold "
                             f"({stats}, then {again})")
    out["job"] = {"seconds": job_s, "split_s": dict(job.seconds),
                  "raw_rows": stats["raw_rows"],
                  "raw_rows_per_s": stats["raw_rows"] / job_s,
                  "raw_chunks_read": stats["raw_chunks"],
                  "raw_bytes_read": stats["raw_bytes"],
                  "ds_partitions": stats["partitions"],
                  "ds_chunks": stats["ds_chunks"],
                  "ds_samples": stats["ds_samples"],
                  "ds_bytes": stats["ds_bytes"],
                  "ds_over_raw_bytes": stats["ds_bytes"]
                  / max(stats["raw_bytes"], 1),
                  "second_catch_up": {k: again[k] for k in (
                      "raw_chunks", "ds_samples", "scanned_from")}}
    log(f"  job: {job_s:.1f} s ({', '.join(f'{k} {v:.1f}' for k, v in job.seconds.items())}), "
        f"{stats['raw_rows']} raw rows ({out['job']['raw_rows_per_s']:.3g}/s), "
        f"{stats['ds_chunks']} ds chunks, {stats['ds_bytes'] / 1e6:.1f} MB "
        f"({out['job']['ds_over_raw_bytes']:.3f} of the raw bytes read); "
        f"the second catch-up scanned nothing")
    # 2. the queries through both planners
    end = now_ms // 1000
    start = end - 6 * 3600
    planners = _lt_planners(store, now_ms)
    services = {name: smoke_service(store, device=dev)
                for name in planners}
    for name, svc in services.items():
        svc.planner = planners[name]
    _build.reset_counts()
    out["queries"] = []
    answers = {}
    for q in LT_QUERIES:
        for name, svc in services.items():
            l0 = dict(_build.LAUNCHES)
            t = time.perf_counter()
            r = svc.query_range(q, start, 60, end)
            cold = (time.perf_counter() - t) * 1000.0
            warm = []
            for _ in range(LT_WARM):
                t = time.perf_counter()
                svc.query_range(q, start, 60, end)
                warm.append((time.perf_counter() - t) * 1000.0)
            if r.stats.engine != "exec":
                raise AssertionError(f"phase 18: {q} through {name} was "
                                     f"served by {r.stats.engine}")
            m = r.result.materialize()
            if m.num_steps != 361 or not np.isfinite(
                    np.asarray(m.values)).any():
                raise AssertionError(f"phase 18: {q} through {name}: "
                                     f"{m.num_steps} steps, no finite value")
            answers[(q, name)] = r
            rec = dict(query=q, planner=name, cold_ms=cold,
                       warm_p50_ms=float(np.median(warm)),
                       rows=m.num_series, engine=r.stats.engine,
                       tiers=r.stats.tiers, host_lane=r.stats.host_lane,
                       launches={k: _build.LAUNCHES[k] - l0[k]
                                 for k in l0})
            out["queries"].append(rec)
            log(f"  {name} {q}: cold {cold:.1f} ms, warm p50 "
                f"{rec['warm_p50_ms']:.1f} ms, {m.num_series} rows, "
                f"engine {r.stats.engine}, tiers "
                f"{ {k: (v['series'], v['chunks']) for k, v in r.stats.tiers.items()} }, "
                f"launches {rec['launches']}")
    out["launches"] = dict(_build.LAUNCHES)
    if dev.type == "cuda" and not all(out["launches"].values()):
        raise AssertionError(f"phase 18: a kernel did not launch on "
                             f"downsampled or cold data: {out['launches']}")
    launches = dict(_build.LAUNCHES)
    # 3. checks: each tier's own answer; the two planners alike; the
    # App-0 subset against the CPU; a warm repeat through the extent cache
    checked = {}
    tier_svc = smoke_service(store, device=dev, engine="exec")
    for q in LT_QUERIES:
        parts = _lt_tier_answers(tier_svc, planners["tiered"], q, start,
                                 end)
        checked[q] = _lt_stitched_check(answers[(q, "tiered")], parts)
        lk, lv = _sorted_answer(answers[(q, "longtime")])
        tk, tv = _sorted_answer(answers[(q, "tiered")])
        if lk != tk or not np.allclose(lv, tv, rtol=1e-9, atol=1e-12,
                                       equal_nan=True):
            raise AssertionError(f"phase 18: {q}: the long-time and the "
                                 f"tiered planners' answers differ")
    cpu_planners = _lt_planners(store, now_ms)
    cpu = smoke_service(store, device="cpu")
    card = smoke_service(store, device=dev)
    vs_cpu = {}
    for q in LT_QUERIES:
        sub = _lt_subset(q)
        cpu.planner, card.planner = cpu_planners["tiered"], \
            planners["tiered"]
        vs_cpu[sub] = _lt_same(card.query_range(sub, start, 60, end),
                               cpu.query_range(sub, start, 60, end),
                               f"phase 18: {sub} (the card against the "
                               f"CPU)")
    cached = smoke_service(store, device=dev, result_cache=True)
    cached.planner = _lt_planners(store, now_ms)["tiered"]
    first = cached.query_range(LT_QUERIES[0], start, 60, end)
    paged = _lt_paged(cached.planner)
    second = cached.query_range(LT_QUERIES[0], start, 60, end)
    if _lt_paged(cached.planner) != paged or not second.stats.cache_hits \
            or not paged[0]:
        raise AssertionError(f"phase 18: the warm repeat through the extent "
                             f"cache paged chunks in ({paged} → "
                             f"{_lt_paged(cached.planner)})")
    _build.LAUNCHES.update(launches)  # the checks' launches are not counted
    out["checks"] = {"tier_steps": checked, "vs_cpu": vs_cpu,
                     "extent_cache": {"cold_paged": paged[0],
                                      "cold_bytes": paged[1],
                                      "warm_hits": second.stats.cache_hits,
                                      "cold_misses":
                                          first.stats.cache_misses}}
    log(f"  checks: every stitched answer equals its tiers' own answers and "
        f"the other planner's; the App-0 subset equals the CPU's; the warm "
        f"repeat through the extent cache paged nothing "
        f"({second.stats.cache_hits} extents hit)")
    tiered_answer = answers[(LT_QUERIES[0], "tiered")]
    del services, tier_svc, cpu, card, cached, planners, cpu_planners
    store.close()
    if dev.type == "cuda":
        import torch

        torch.cuda.empty_cache()
    # 4. the node
    out["node"] = _lt_node(dev, root, now_ms, tiered_answer, series)
    return out


def _lt_same(got, want, what: str, check: bool = True) -> dict:
    """The largest difference of two answers and the cells past
    ``LT_TOL``; raises where they differ and ``check`` is set."""
    gk, gv = _sorted_answer(got)
    wk, wv = _sorted_answer(want)
    if gk != wk or gv.shape != wv.shape:
        raise AssertionError(f"{what}: the answers' series differ")
    bad = ~np.isclose(gv, wv, **LT_TOL)
    fin = np.isfinite(wv) & np.isfinite(gv)
    out = {"max_abs": float(np.abs(gv[fin] - wv[fin]).max(initial=0.0)),
           "rows": len(gk), "cells_past_tol": int(bad.sum())}
    if bad.any():
        at = tuple(np.argwhere(bad)[0])
        out["first"] = {"key": gk[at[0]], "step": int(at[1]),
                        "got": float(gv[at]), "want": float(wv[at])}
        if check:
            raise AssertionError(f"{what}: the answers differ: {out}")
    return out


# phase 19: the object-store tier. Phase 18's generator and shapes (6 h at
# 10 s, 4 shards, spread 1, 400-sample chunks; counters and a quarter as
# many load averages) on a directory-backed FakeS3 with the reference's
# ``store`` defaults (1 MiB segments, 8 buckets, a queue of 64 uploads):
# the flush, a restart that recovers every shard from the bucket, then
# over the restarted store a tiered planner (memstore the last hour, the
# cold tier the rest: no downsample tier) and its queries. The series and
# the history are cut (PERF.md §4), the widths and the store's defaults
# are not.
# counters in the full smoke: cut from 10,000 for phase 20's room
OS_SERIES = 2_500
OS_SERIES_ALONE = 100_000       # counters under --objectstore-only
OS_MEM_RETENTION_MS = 3_600_000
OS_WARM = 2
OS_SUBSET = '_ns_="App-0"'


def objectstore_phase(dev, args) -> dict:
    """Phase 19: the object-store tier (see the module)."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="filodb-objectstore-")
    try:
        out = _objectstore(dev, args, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 19 took {out['seconds']:.1f} s")
    return out


def _os_store(root: str, bucket: str, **store_cfg):
    """A 4-shard, spread-1 store over the object store of
    ``<root>/<bucket>`` (the reference's ``store`` defaults)."""
    from filodb_tpu_torch.core.memstore.memstore import MemStore
    from filodb_tpu_torch.core.store.config import StoreConfig
    from filodb_tpu_torch.core.store.objectstore import open_object_store

    cs, meta = open_object_store({"endpoint": str(Path(root) / bucket)},
                                 root)
    return MemStore(4, 1, column_store=cs, meta_store=meta,
                    config=StoreConfig(max_chunk_size=400,
                                       groups_per_shard=20,
                                       retention_ms=NODE_RETENTION_MS,
                                       max_query_matches=0, **store_cfg),
                    dataset=LT_DS)


def _os_counters():
    from filodb_tpu_torch.core.store import objectstore as osm

    return {"puts": osm.PUTS.value, "gets": osm.GETS.value,
            "bytes_up": osm.BYTES_UP.value, "bytes_down": osm.BYTES_DOWN.value,
            "payload_down": osm.PAYLOAD_BYTES_DOWN.value}


def _os_delta(before: dict) -> dict:
    now = _os_counters()
    return {k: now[k] - before[k] for k in now}


def _os_tiered(store, now_ms: int):
    from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
    from filodb_tpu_torch.coordinator.tiered_planner import (
        build_tiered_planner,
    )
    from filodb_tpu_torch.core.store.objectstore import (
        ObjectStoreColumnStore,
    )

    cs = store.column_store
    reader = ObjectStoreColumnStore(cs.client, bucket=cs.bucket)
    return build_tiered_planner(
        SingleClusterPlanner(4, 1), reader, LT_DS, 4, 1,
        mem_retention_ms=OS_MEM_RETENTION_MS, raw_retention_ms=None,
        odp_max_chunks=LT_ODP_CHUNKS, now_ms=lambda: now_ms)


def _os_ingest(stores, series: int, seed: int, keep=None) -> tuple:
    """Phase 18's counters and load averages into each of ``stores`` (the
    rows ``keep`` selects, where given, into the last); → (samples kept,
    the largest value)."""
    rng = np.random.default_rng(seed + 19)
    kept, vmax = 0, -np.inf
    for metric in (M, LOAD1):
        n = series if metric == M else series // LT_GAUGES
        for a in range(0, n, 65536):
            b = min(a + 65536, n)
            if metric == M:
                labels, ts, vals = make_series(rng, a, b, LT_SAMPLES)
                schema = "prom-counter"
            else:
                labels, ts, vals = make_host_series(rng, LOAD1, a, b,
                                                    LT_SAMPLES)
                schema = "gauge"
            vmax = max(vmax, float(np.nanmax(vals)))
            for i, st in enumerate(stores):
                if keep is not None and i == len(stores) - 1:
                    at = [j for j, lb in enumerate(labels) if keep(lb)]
                    st.ingest_series([labels[j] for j in at], ts[at],
                                     vals[at], schema=schema)
                else:
                    kept += st.ingest_series(labels, ts, vals,
                                             schema=schema)
    return kept, vmax


def _objectstore(dev, args, root: str) -> dict:
    import threading

    from filodb_tpu_torch import _build
    from filodb_tpu_torch.core.store import objectstore as osm
    from filodb_tpu_torch.query.engine import sidecar_lane

    series = args.objectstore_series
    gauges = series // LT_GAUGES
    now_ms = T0_MS + LT_SAMPLES * 10_000
    end = now_ms // 1000
    # the writer, and a local-disk store of App-0's series (the backend
    # the answers are held against)
    store = _os_store(root, "bucket")
    local = durable_store(str(Path(root) / "local"), LT_DS,
                          retention_ms=NODE_RETENTION_MS,
                          max_query_matches=0)
    t = time.perf_counter()
    kept, vmax = _os_ingest([store, local], series, args.seed,
                            keep=lambda lb: lb["_ns_"] == "App-0")
    ingest_s = time.perf_counter() - t
    # 1. the flush, with the upload queue's depth sampled meanwhile
    depth, done = [], threading.Event()

    def sample():
        while not done.is_set():
            depth.append(osm.QUEUE_DEPTH.value)
            time.sleep(0.01)

    sampler = threading.Thread(target=sample, daemon=True)
    c0 = _os_counters()
    t = time.perf_counter()
    sampler.start()
    chunks = store.flush_all()
    flush_s = time.perf_counter() - t
    store.column_store.flush()
    upload_s = time.perf_counter() - t
    done.set()
    sampler.join()
    up = _os_delta(c0)
    stats = store.column_store.dataset_stats(LT_DS)
    local.flush_all()
    log(f"phase 19: the object-store tier: {series} counters and {gauges} "
        f"load averages x {LT_SAMPLES} samples (6 h), {kept} kept, ingested "
        f"in {ingest_s:.1f} s; flush {flush_s:.1f} s ({chunks} chunks), "
        f"uploads drained at {upload_s:.1f} s: {up['puts']} PUTs, "
        f"{up['bytes_up'] / 1e6:.1f} MB, {stats['segments']} segments, "
        f"queue depth max {max(depth, default=0):.0f}")
    out = {"counters": series, "gauges": gauges, "samples": LT_SAMPLES,
           "ingest_s": ingest_s, "flush_s": flush_s, "upload_s": upload_s,
           "chunks": chunks, "puts": up["puts"], "bytes_up": up["bytes_up"],
           "segments": stats["segments"], "segment_bytes": stats["bytes"],
           "queue_depth_max": max(depth, default=0),
           "queue_depth_p50": float(np.median(depth)) if depth else 0.0}
    store.close()
    # 2. a restart from the bucket: every shard's index recovered
    c0 = _os_counters()
    t = time.perf_counter()
    store = _os_store(root, "bucket")
    keys = sum(store.recover_index(s) for s in range(4))
    boot_s = time.perf_counter() - t
    down = _os_delta(c0)
    if keys != series + gauges:
        raise AssertionError(f"phase 19: the restart recovered {keys} part "
                             f"keys of {series + gauges}")
    out["restart"] = {"seconds": boot_s, "keys": keys, "gets": down["gets"],
                      "bytes_down": down["bytes_down"]}
    log(f"  restart from the bucket: {keys} part keys in {boot_s:.1f} s "
        f"({down['gets']} GETs, {down['bytes_down'] / 1e6:.1f} MB)")
    # 3. the queries over the restarted store, launches counted
    svc = smoke_service(store, device=dev, engine="exec")
    svc.planner = _os_tiered(store, now_ms)
    cold = svc.planner.cold_planner.store
    start = end - 6 * 3600
    interior = (f"max_over_time({M}[2h])", T0_MS // 1000 + 3995,
                T0_MS // 1000 + 3995)
    queries = {
        "tiered_rate": (f"sum(rate({M}[15m])) by (_ns_)", start, 60, end),
        "max": (f"max_over_time({M}[3h])", start + 3 * 3600, 900,
                end - 3600),
        "avg": (f"avg_over_time({M}[3h])", start + 3 * 3600, 900,
                end - 3600)}
    _build.reset_counts()
    out["queries"] = {}
    answers = {}
    for name, (q, a, step, b) in queries.items():
        for lane in ("pyramid", "decode"):
            with valves(FILODB_SIDECARS="1" if lane == "pyramid" else "0"):
                cold.clear_caches()
                c0 = _os_counters()
                t = time.perf_counter()
                r = svc.query_range(q, a, step, b)
                cold_ms = (time.perf_counter() - t) * 1000.0
                io = _os_delta(c0)
                warm = []
                for _ in range(OS_WARM):
                    t = time.perf_counter()
                    svc.query_range(q, a, step, b)
                    warm.append((time.perf_counter() - t) * 1000.0)
            m = r.result.materialize()
            if not np.isfinite(np.asarray(m.values)).any():
                raise AssertionError(f"phase 19: {q} ({lane}): no finite "
                                     f"value")
            answers[(name, lane)] = r
            rec = {"query": q, "lane": lane, "cold_ms": cold_ms,
                   "warm_p50_ms": float(np.median(warm)),
                   "rows": m.num_series, "steps": m.num_steps,
                   "tiers": sorted(r.stats.tiers),
                   "pyramid": dict(r.stats.pyramid),
                   "bypassed": dict(r.stats.sidecar_bypassed),
                   "gets": io["gets"], "payload_bytes": io["payload_down"],
                   "bytes_down": io["bytes_down"]}
            out["queries"][f"{name}/{lane}"] = rec
            log(f"  {q} ({lane}): cold {cold_ms:.1f} ms, warm p50 "
                f"{rec['warm_p50_ms']:.1f} ms, {m.num_series} rows, tiers "
                f"{rec['tiers']}, {io['gets']} GETs, "
                f"{io['payload_down'] / 1e6:.2f} MB payload, pyramid "
                f"{rec['pyramid']}")
    # the interior-only window: stored roll-ups, no payload
    cold.clear_caches()
    c0 = _os_counters()
    r = svc.query_range(*interior[:2], 60, interior[2])
    io = _os_delta(c0)
    p = r.stats.pyramid
    if io["payload_down"] or p.get("payloadBytes") or not (
            p.get("segmentNodes", 0) + p.get("chunkNodes", 0)):
        raise AssertionError(f"phase 19: the interior-only window paged "
                             f"payload or folded no node ({io}, {p})")
    out["interior"] = {"query": interior[0], "payload_bytes":
                       io["payload_down"], "pyramid": dict(p),
                       "pyramid_bytes": p.get("pyramidBytes", 0)}
    launches = dict(_build.LAUNCHES)
    out["launches"] = launches
    log(f"  interior-only window: 0 payload bytes, {p}; launches {launches}")
    if dev.type == "cuda" and not all(launches.values()):
        raise AssertionError(f"phase 19: a kernel did not launch over the "
                             f"object store: {launches}")
    for name in ("max", "avg"):
        pyr = out["queries"][f"{name}/pyramid"]
        if not pyr["pyramid"] or pyr["bypassed"]:
            raise AssertionError(f"phase 19: the pyramid lane did not serve "
                                 f"{pyr['query']}: {pyr['bypassed']}")
    # 4. checks: each pyramid answer against the lane off (rate's reported:
    # the lane's rate is the reference's formula over stats, the decode
    # lane's B3, whose time arithmetic differs, ROADMAP §C); the App-0
    # subset against the local-disk store, both lanes off so both decode,
    # and against the CPU with the lanes on
    checks = {}
    for name in queries:
        checks[f"{name}_vs_decode"] = _lt_same(
            answers[(name, "pyramid")], answers[(name, "decode")],
            f"phase 19: {name} (pyramid against FILODB_SIDECARS=0)",
            check=name != "tiered_rate")
    local_svc = smoke_service(local, device=dev, engine="exec")
    local_svc.planner = _os_tiered_local(local, now_ms)
    cpu = smoke_service(store, device="cpu", engine="exec")
    cpu.planner = _os_tiered(store, now_ms)
    for name, (q, a, step, b) in queries.items():
        sub = q.replace(f"{M}[", f"{M}{{{OS_SUBSET}}}[")
        with valves(FILODB_SIDECARS="0"):
            checks[f"{name}_vs_local"] = _lt_same(
                svc.query_range(sub, a, step, b),
                local_svc.query_range(sub, a, step, b),
                f"phase 19: {sub} (object store against the local disk)")
        checks[f"{name}_vs_cpu"] = _lt_same(
            svc.query_range(sub, a, step, b),
            cpu.query_range(sub, a, step, b),
            f"phase 19: {sub} (the card against the CPU)")
    _build.LAUNCHES.update(launches)  # the checks' launches are not counted
    # 5. the approximate lane: summary-only, no payload
    with valves(FILODB_SIDECAR_APPROX="1"):
        c0 = _os_counters()
        t = time.perf_counter()
        top = cold.approx_topk(10)
        card = cold.approx_cardinality()
        approx_ms = (time.perf_counter() - t) * 1000.0
        io = _os_delta(c0)
    n_all = series + gauges
    if io["payload_down"] or abs(card - n_all) / n_all > 0.1 \
            or top[0]["value"] != vmax \
            or [e["value"] for e in top] != sorted(
                (e["value"] for e in top), reverse=True):
        raise AssertionError(f"phase 19: approx: cardinality {card} of "
                             f"{n_all}, top {top[:2]}, max {vmax}, {io}")
    out["approx"] = {"ms": approx_ms, "cardinality": card, "series": n_all,
                     "top1": top[0]["value"], "pyramid_bytes":
                     io["bytes_down"], "payload_bytes": io["payload_down"]}
    out["checks"] = checks
    log(f"  checks: max and avg through the pyramid lane equal "
        f"FILODB_SIDECARS=0's (rate: {checks['tiered_rate_vs_decode']}); "
        f"the App-0 subset equals the local disk's and the CPU's; "
        f"approx_cardinality "
        f"{card:.0f} of {n_all}, approx_topk's first {top[0]['value']} (the "
        f"largest value), in {approx_ms:.1f} ms with no payload")
    store.close()
    local.close()
    if dev.type == "cuda":
        import torch

        torch.cuda.empty_cache()
    return out


def _os_tiered_local(store, now_ms: int):
    from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
    from filodb_tpu_torch.coordinator.tiered_planner import (
        build_tiered_planner,
    )

    return build_tiered_planner(
        SingleClusterPlanner(4, 1), store.column_store, LT_DS, 4, 1,
        mem_retention_ms=OS_MEM_RETENTION_MS, raw_retention_ms=None,
        odp_max_chunks=LT_ODP_CHUNKS, now_ms=lambda: now_ms)


# phase 20: standing queries. Step 1 runs two rule groups over the phase-2
# store (after phase 17's seal wave; under --rules-only after phase 2 and
# the same seal wave) through a MemstoreSink: a 60 s group (RULE_RATE
# recorded, and an alert on it above the median of its fresh-start values,
# for: 1m) and a 10 s group (RULE_SUM recorded); a fresh-start tick of
# each, RULE_SCRAPES scrapes of every series through the C++ pass (phase
# 17's templates) with the 60 s group ticked after every sixth and the
# 10 s group once at the end (a catch-up of 12 steps), an idle tick, then
# the recorded series against the expressions polled over the recorded
# steps, the alerts' states, and a second manager a group that must
# recover each watermark and evaluate nothing. Step 2 boots a node over
# phase 11's directory (after phase 12's node stopped) with rules.groups,
# selfmon and a webhook, checks the new routes over HTTP, restarts it and
# checks that the group resumed at its watermark with no gap and no
# double write.
RULE_RATE = f"sum(rate({M}[5m])) by (_ns_)"
RULE_SUM = f"sum(sum_over_time({M}[1m])) by (job)"
REC_RATE = "ns:http_requests:rate5m"
REC_SUM = "job:http_requests:sum1m"
RULE_SCRAPES = 12
RULE_NODE_SERIES = 100          # the series phase 20's node scrapes and reads
RULE_BUDGET_S = 90.0            # the phase's share of the smoke's limit


def _rule_scrape(store, temps, last, rng, base_ms: int, k: int) -> None:
    """Scrape ``k`` (1-based) of every series at ``base_ms`` + 10 s k with
    the generator's jitter, each counter from ``last`` on (updated)."""
    from concurrent.futures import ThreadPoolExecutor

    for x, v in zip(temps, last):
        P = len(x["keys"])
        v += rng.integers(0, 20, P)
        _patch(x["buf"], x["ts_off"], base_ms + 10_000 * k
               + rng.integers(-500, 501, P))
        _patch(x["buf"], x["val_off"], v)
    with ThreadPoolExecutor(len(temps)) as pool:
        done = list(pool.map(
            lambda sx: _scrape(sx[0], sx[1], sx[0].latest_offset + 1),
            zip(store.shards, temps)))
    sent = sum(len(x["keys"]) for x in temps)
    if sum(n for n, _ in done) != sent:
        raise AssertionError(f"phase 20: scrape {k}: "
                             f"{sum(n for n, _ in done)} of {sent} kept")


class _RuleTicks:
    """Each rule tick of the phase: the manager's evaluations, wall ms,
    the lane and ms of each of its queries and the kernels' launches."""

    def __init__(self, svc):
        from filodb_tpu_torch.query.engine import sidecar_lane

        self.svc, self.lane, self.rows = svc, sidecar_lane, []
        self._served = []
        self._query = svc.query_range

        def recorded(promql, start, step, end, qcontext=None):
            served = sidecar_lane.SIDECAR_SERVED.value
            t = time.perf_counter()
            res = self._query(promql, start, step, end, qcontext)
            self._served.append((
                "sidecar" if sidecar_lane.SIDECAR_SERVED.value > served
                else res.stats.engine,
                round((time.perf_counter() - t) * 1000.0, 1)))
            return res

        svc.query_range = recorded

    def close(self) -> None:
        del self.svc.query_range  # the class's method again

    def tick(self, mgr, what: str) -> int:
        from filodb_tpu_torch import _build

        g = mgr.groups[0]
        before = mgr._state[g.name].last_step
        self._served = []
        launched = dict(_build.LAUNCHES)
        t = time.perf_counter()
        n = mgr.tick()
        ms = (time.perf_counter() - t) * 1000.0
        wm = mgr._state[g.name].last_step
        steps = 0 if before is None or wm is None \
            else (wm - before) // g.interval_ms
        row = {"tick": what, "group": g.name, "evaluated": n,
               "steps": steps if before is not None else int(n > 0),
               "ms": ms, "queries": list(self._served),
               "launches": {k: v - launched[k]
                            for k, v in _build.LAUNCHES.items()},
               "watermark": wm,
               "error": mgr._state[g.name].last_error}
        self.rows.append(row)
        log(f"  {what}: {g.name} evaluated {n} (rule, step) pairs over "
            f"{row['steps']} step(s) in {ms:.1f} ms; its queries' lanes and "
            f"ms {row['queries']}; launches {row['launches']}; watermark "
            f"{wm}"
            + (f"; error {row['error']}" if row["error"] else ""))
        if row["error"]:
            raise AssertionError(f"phase 20: {what}: {row['error']}")
        return n


def _written(store, metric: str, label: str, start_ms: int, step_ms: int,
             end_ms: int) -> dict:
    """The rule outputs ``metric`` as written, read from the shards (their
    exact float64 samples, no query engine): {label value: values at the
    steps [start, end], NaN where none}."""
    from filodb_tpu_torch.core.filters import ColumnFilter, Equals

    steps = np.arange(start_ms, end_ms + 1, step_ms)
    out = {}
    for shard in store.shards:
        pids = shard.lookup_partitions(
            [ColumnFilter("_metric_", Equals(metric))], start_ms, end_ms)
        if not len(pids):
            continue
        row, ts, vals = shard.exact_samples(pids, start_ms, end_ms)
        for i, pid in enumerate(pids.tolist()):
            got = np.full(len(steps), np.nan)
            sel = row == i
            at = np.searchsorted(steps, ts[sel])
            if (steps[np.minimum(at, len(steps) - 1)] != ts[sel]).any():
                raise AssertionError(f"phase 20: {metric} written off its "
                                     f"steps")
            got[at] = vals[sel]
            out[shard.keys[pid].label_map.get(label)] = got
    return out


def _poll_next(svc, g, wm, polled: dict, label: str) -> float:
    """Poll the first rule of group ``g`` over the steps its next tick will
    evaluate (from its watermark ``wm``, None for a fresh start, to the
    last step the ingest horizon completed; no out-of-order allowance),
    into ``polled`` {label value: {step: value}}. Run just before the tick,
    at the store's version the tick reads, the poll leaves the tick's leaf
    batches warm. Returns its ms."""
    horizon = min(sh.max_ingested_ts for sh in svc.memstore.shards)
    last = horizon // g.interval_ms * g.interval_ms
    first = last if wm is None else wm + g.interval_ms
    t = time.perf_counter()
    res = svc.query_range(g.rules[0].expr, first // 1000,
                          g.interval_ms // 1000, last // 1000)
    ms = (time.perf_counter() - t) * 1000.0
    vals = np.asarray(res.result.values, dtype=float)
    steps = np.asarray(res.result.steps_ms).tolist()
    for j, k in enumerate(res.result.keys):
        polled.setdefault(dict(k.labels).get(label), {}).update(
            zip(steps, vals[j].tolist()))
    return ms


def _recorded_equal(store, record: str, expr: str, label: str, polled: dict,
                    start_ms: int, step_ms: int, end_ms: int) -> dict:
    """The recorded series as written against ``polled``, ``expr`` polled
    over the recorded steps, at the reference's rule tolerance
    (``tests/test_rules.py``: rtol 2e-5, atol 1e-9)."""
    t = time.perf_counter()
    rec = _written(store, record, label, start_ms, step_ms, end_ms)
    if set(polled) != set(rec) or not polled:
        raise AssertionError(f"phase 20: {record}: series {sorted(rec)[:5]} "
                             f"against polled {sorted(polled)[:5]}")
    worst = 0.0
    for k, at in polled.items():
        want = np.array([at.get(t, np.nan) for t in range(
            start_ms, end_ms + 1, step_ms)])
        got = rec[k]
        if not np.array_equal(np.isnan(got), np.isnan(want)) \
                or not np.allclose(got, want, rtol=2e-5, atol=1e-9,
                                   equal_nan=True):
            raise AssertionError(f"phase 20: {record}{{{label}={k}}}: "
                                 f"{got} against polled {want}")
        fin = np.isfinite(want)
        if fin.any():
            worst = max(worst, float(np.max(np.abs(got[fin] - want[fin])
                                            / np.maximum(np.abs(want[fin]),
                                                         1e-30))))
    steps = (end_ms - start_ms) // step_ms + 1
    log(f"  {record}: {len(polled)} series x {steps} steps as written equal "
        f"to {expr} polled (max rel err {worst:.3g}); read in "
        f"{time.perf_counter() - t:.1f} s")
    return {"series": len(polled), "steps": steps, "max_rel_err": worst,
            "values": rec}


def rules_phase(svc, args, keep: dict | None = None) -> dict:
    """Phase 20 step 1 (see the comment above ``RULE_RATE``); ``keep`` is
    phase 17's (the templates and the last counter values), else they are
    made here and the store sealed as phase 17 seals it. The ticks and the
    polls run with ``FILODB_SIDECAR_SEALED_GATE=0``: at 250,000 sealed
    partitions a shard the lane's static gate sends a one-step tick to the
    decode lane, which packs every series' last chunk again after each
    write (16.5-66.1 s a tick at 1 M series, PERF.md)."""
    from concurrent.futures import ThreadPoolExecutor

    from filodb_tpu_torch.rules import (
        AlertingRule,
        MemstoreSink,
        RecordingRule,
        RuleGroup,
        RuleManager,
    )
    from filodb_tpu_torch import _build
    from filodb_tpu_torch.rules import manager as mgr_mod

    t_phase = time.perf_counter()
    store = svc.memstore
    log(f"phase 20: standing queries over the phase-2 store "
        f"({sum(sh.num_partitions for sh in store.shards)} series)")
    if keep:
        temps, last = keep["temps"], [v.copy() for v in keep["last"]]
    else:
        temps = scrape_templates(store)
        last = []
        for shard, x in zip(store.shards, temps):
            rows = shard.buffers.slot[:len(x["keys"])]
            last.append(shard.buffers.vals[rows, shard.buffers.n[rows] - 1]
                        .copy())
        t = time.perf_counter()
        with ThreadPoolExecutor(len(temps)) as pool:
            list(pool.map(lambda sh: sh.seal(np.arange(sh.num_partitions)),
                          store.shards))
        log(f"  templates made and the store sealed (as phase 17's seal "
            f"wave) in {time.perf_counter() - t:.1f} s")
    last = [np.where(np.isnan(v), 0.0, v) for v in last]
    gate = valves(FILODB_SIDECAR_SEALED_GATE="0")
    g60 = RuleGroup("smoke_60s", 60_000, store.dataset,
                    (RecordingRule(REC_RATE, RULE_RATE),))
    g10 = RuleGroup("smoke_10s", 10_000, store.dataset,
                    (RecordingRule(REC_SUM, RULE_SUM),))
    # the threshold: the median of the fresh-start step's values, polled
    # before the group (with its alert) is made
    polled = {REC_RATE: {}, REC_SUM: {}}
    with gate:
        out = {"polls_ms": [_poll_next(svc, g60, None, polled[REC_RATE],
                                       "_ns_")]}
    thr = round(float(np.median([v for at in polled[REC_RATE].values()
                                 for v in at.values()])), 6)
    # the alert on the recorded series, a rule after it in the group
    g60 = RuleGroup("smoke_60s", 60_000, store.dataset, (
        RecordingRule(REC_RATE, RULE_RATE),
        AlertingRule("SmokeRateHigh", f"{REC_RATE} > {thr:.6f}",
                     for_ms=60_000)))
    sink = MemstoreSink(store, store.dataset, store.num_shards, store.spread)

    def managers():
        m60 = RuleManager(svc, sink, [g60], ooo_allowance_ms=0)
        m10 = RuleManager(svc, sink, [g10], ooo_allowance_ms=0)
        # two managers over one service: the cache's floor is the lower
        svc.rules_horizon_floor = lambda: min(m60.horizon_floor(),
                                              m10.horizon_floor())
        return m60, m10

    m60, m10 = managers()
    ticks = _RuleTicks(svc)
    out["threshold"] = thr
    # the phase's launches: the polls and the ticks (a tick after its poll
    # finds the poll's batches and windows, and launches only what is new)
    _build.reset_counts()

    def poll(mgr, rec, label):
        g = mgr.groups[0]
        out["polls_ms"].append(_poll_next(svc, g, mgr._state[g.name].last_step,
                                          polled[rec], label))

    try:
        with gate:
            ticks.tick(m60, "fresh start")
            poll(m10, REC_SUM, "job")
            ticks.tick(m10, "fresh start")
            first60, first10 = (m._state[g.name].last_step
                                for m, g in ((m60, g60), (m10, g10)))
            rng = np.random.default_rng(args.seed + 20)
            # the scrapes go on from the last 10 s grid point sampled
            base = (max(sh.max_ingested_ts for sh in store.shards) + 500) \
                // 10_000 * 10_000
            scrape_s = 0.0
            for k in range(1, RULE_SCRAPES + 1):
                ts = time.perf_counter()
                _rule_scrape(store, temps, last, rng, base, k)
                scrape_s += time.perf_counter() - ts
                if k % 6 == 0:
                    poll(m60, REC_RATE, "_ns_")
                    ticks.tick(m60, f"after scrape {k}")
            poll(m10, REC_SUM, "job")
            ticks.tick(m10, f"catch-up after {RULE_SCRAPES} scrapes")
            out["scrapes_s"] = scrape_s
            idle = ticks.tick(m60, "idle") + ticks.tick(m10, "idle")
            if idle:
                raise AssertionError(f"phase 20: the idle ticks evaluated "
                                     f"{idle}")
            wm60, wm10 = m60._state[g60.name].last_step, \
                m10._state[g10.name].last_step
            caught = (wm10 - first10) // 10_000
            if caught != (min(sh.max_ingested_ts for sh in store.shards)
                          // 10_000 * 10_000 - first10) // 10_000 \
                    or caught < RULE_SCRAPES:
                raise AssertionError(f"phase 20: the 10 s group caught up "
                                     f"{caught} steps")
    finally:
        ticks.close()
    rows = ticks.rows
    out["ticks"] = rows
    out["launches"] = dict(_build.LAUNCHES)
    tick_launches = {k: sum(r["launches"][k] for r in rows)
                     for k in out["launches"]}
    if svc.device.type == "cuda" and not any(tick_launches.values()):
        raise AssertionError("phase 20: the rule ticks launched no kernel")
    rec = _recorded_equal(store, REC_RATE, RULE_RATE, "_ns_",
                          polled[REC_RATE], first60, 60_000, wm60)
    out["recorded"] = {
        REC_RATE: rec,
        REC_SUM: _recorded_equal(store, REC_SUM, RULE_SUM, "job",
                                 polled[REC_SUM], first10, 10_000, wm10)}
    log(f"  the polls before the ticks: {[round(x) for x in out['polls_ms']]}"
        f" ms (each at the version and grid of the tick after it)")
    # the alerts: pending at the first step a namespace is above the
    # threshold, firing a step (for: 1m) later
    above = {ns: v > thr for ns, v in rec.pop("values").items()}
    out["recorded"][REC_SUM].pop("values")
    states = m60._state[g60.name].alert_states["SmokeRateHigh"]
    got = {dict(k)["_ns_"]: st.firing for k, st in states.items()}
    want = {ns: bool(a[-2]) for ns, a in above.items() if a[-1]}
    if got != want:
        raise AssertionError(f"phase 20: alert states "
                             f"{sorted(got.items())[:5]} against "
                             f"{sorted(want.items())[:5]}")
    firing = sum(got.values())
    if not firing:
        raise AssertionError("phase 20: no alert fired")
    out["alerts"] = {"firing": firing, "pending": len(got) - firing,
                     "above": [int(sum(a[j] for a in above.values()))
                               for j in range(3)],
                     "transitions": mgr_mod.alerts_transitions.value}
    log(f"  alerts over {thr:.6f}: {firing} firing, {len(got) - firing} "
        f"pending of {len(above)} namespaces (above at each step: "
        f"{out['alerts']['above']}); the states the steps' values give")
    # a restart: fresh managers on the same store recover each watermark
    skipped = mgr_mod.rules_steps_skipped.value
    n60, n10 = managers()
    t = time.perf_counter()
    with gate:
        again = n60.tick() + n10.tick()
    out["recovery_ms"] = (time.perf_counter() - t) * 1000.0
    got_wm = (n60._state[g60.name].last_step, n10._state[g10.name].last_step)
    if again or got_wm != (wm60, wm10) \
            or mgr_mod.rules_steps_skipped.value != skipped:
        raise AssertionError(f"phase 20: recovery evaluated {again}, "
                             f"watermarks {got_wm} against {(wm60, wm10)}")
    rec_states = n60._state[g60.name].alert_states["SmokeRateHigh"]
    if {dict(k)["_ns_"]: s.firing for k, s in rec_states.items()} != got:
        raise AssertionError("phase 20: the recovered alert states differ")
    del svc.rules_horizon_floor
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  a second manager a group recovered both watermarks and the "
        f"alert states in {out['recovery_ms']:.1f} ms, evaluated and "
        f"skipped nothing; launches in the ticks {tick_launches}, with the "
        f"polls {out['launches']}; step 1 "
        f"took {out['seconds']:.1f} s (the phase's share "
        f"{RULE_BUDGET_S:.0f} s)")
    return out


def _webhook():
    """A local HTTP receiver of alert notifications: (server, bodies)."""
    import http.server
    import threading

    bodies = []

    class Hook(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            bodies.append(json.loads(self.rfile.read(
                int(self.headers["Content-Length"]))))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Hook)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, bodies


def _rules_node_config(root: str, hook_port: int) -> str:
    """Phase 20's node: phase 12's config with the 60 s group (its alert
    over 0: every namespace with a positive rate), selfmon every second
    and the webhook."""
    path = node_config(root)
    conf = json.loads(Path(path).read_text())
    conf["rules"] = {
        "tick_s": 0.5,
        "groups": [{"name": "smoke_60s", "interval": "60s", "rules": [
            {"record": REC_RATE, "expr": RULE_RATE},
            {"alert": "SmokeRateUp", "expr": f"{RULE_RATE} > 0",
             "for": "1m", "annotations": {"summary": "requests flow"}}]}],
        "notify": {"webhook_url": f"http://127.0.0.1:{hook_port}/alerts",
                   "timeout_s": 5.0}}
    conf["selfmon"] = {"enabled": True, "interval_s": 1}
    Path(path).write_text(json.dumps(conf))
    return path


def _wait(what: str, pred, timeout_s: float = 120.0):
    deadline = time.perf_counter() + timeout_s
    while True:
        got = pred()
        if got:
            return got
        if time.perf_counter() > deadline:
            raise AssertionError(f"phase 20: {what}: not in {timeout_s} s")
        time.sleep(0.1)


def _group_wm(port: int, name: str = "smoke_60s"):
    code, body, _ = http_get(port, "/api/v1/rules")
    for g in json.loads(body)["data"]["groups"] if code == 200 else []:
        if g["name"] == name:
            return g["watermark"]
    return None


def _node_scrape(srv, series, dt_ms: int) -> None:
    """One sample each of ``series`` ((labels, ts, value) a series, the
    last sent) ``dt_ms`` later, as Influx lines; waits until ingested."""
    import socket

    lines = []
    for i, (labels, ts, v) in enumerate(series):
        ts, v = ts + dt_ms, v + 5.0
        series[i] = (labels, ts, v)
        tags = ",".join(f"{a}={b}" for a, b in labels if a != "_metric_")
        lines.append(f"{M},{tags} counter={v!r} {ts * 1_000_000}\n")
    with socket.create_connection(("127.0.0.1", srv.gateway.port)) as c:
        c.sendall("".join(lines).encode())
    workers = [w for (ds, _), w in srv.node._workers.items() if ds == NODE_DS]
    _wait("the scrape ingested", lambda: srv.gateway.sink.flush() or all(
        w.offset >= w.log.latest_offset for w in workers))


def rules_node_phase(dev, args) -> dict:
    """Phase 20 step 2 (see the comment above ``RULE_RATE``)."""
    from filodb_tpu_torch import _build
    from filodb_tpu_torch.http import remote_read as rr

    t_phase = time.perf_counter()
    log("phase 20, step 2: a node with rules.groups, selfmon and a webhook "
        "over phase 11's directory")
    hook, posts = _webhook()
    path = _rules_node_config(args.durable_dir, hook.server_address[1])
    out = {}
    srv, out["boot1"] = boot_node(path, dev, "boot 1")
    try:
        port = srv.http.port
        wm0 = _wait("the fresh-start tick", lambda: _group_wm(port))
        # the node's 100 series instance-0..99 through remote read, each
        # against the shard's exact reader
        req = rr._ld(1, rr._key(1, 0) + rr._varint(0) + rr._key(2, 0)
                     + rr._varint(2**62)
                     + rr._ld(3, rr._ld(2, b"__name__") + rr._ld(3, M.encode()))
                     + rr._ld(3, rr._key(1, 0) + rr._varint(2)
                              + rr._ld(2, b"instance")
                              + rr._ld(3, b"instance-[0-9]{1,2}")))
        import urllib.request

        t = time.perf_counter()
        with urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/promql/{NODE_DS}/api/v1/read",
                data=req, method="POST"), timeout=900) as r:
            enc, payload = r.headers["Content-Encoding"], r.read()
        out["remote_read_ms"] = (time.perf_counter() - t) * 1000.0
        series, n_samples = [], 0
        for _, _, qr in rr._iter_fields(rr.maybe_decompress(payload)):
            for _, _, msg in rr._iter_fields(qr):
                labels, ts, vals = {}, [], []
                for f, _, v in rr._iter_fields(msg):
                    if f == 1:
                        kv = {a: x.decode() for a, _, x in rr._iter_fields(v)}
                        labels["_metric_" if kv[1] == "__name__"
                               else kv[1]] = kv[2]
                    else:
                        s = dict((a, x) for a, _, x in rr._iter_fields(v))
                        vals.append(np.frombuffer(s[1], np.float64)[0])
                        ts.append(s[2])
                series.append((labels, np.array(ts), np.array(vals)))
        if len(series) != RULE_NODE_SERIES:
            raise AssertionError(f"phase 20: remote read gave {len(series)} "
                                 f"series")
        from filodb_tpu_torch.core.partkey import PartKey

        store = srv.node.memstores[NODE_DS]
        for labels, ts, vals in series:
            key = PartKey.create("prom-counter", labels)
            shard = store.shards[int(store.shard_of([key])[0])]
            pid = shard.lookup_keys([key.serialized])
            _, wts, wvals = shard.exact_samples(pid, 0, 2**62)
            keep = ~np.isnan(wvals)
            if not (np.array_equal(ts, wts[keep])
                    and np.array_equal(vals, wvals[keep])):
                raise AssertionError(f"phase 20: remote read of {labels}: "
                                     f"not the shard's samples")
            n_samples += len(ts)
        out["remote_read"] = {"series": len(series), "samples": n_samples,
                              "bytes": len(payload), "encoding": enc}
        log(f"  remote read: {len(series)} series, {n_samples} samples "
            f"({len(payload) / 1e6:.2f} MB, {enc}) in "
            f"{out['remote_read_ms']:.1f} ms, each equal to its shard's "
            f"exact samples")
        feed = [(tuple(sorted(lb.items())), int(ts[-1]), float(vals[-1]))
                for lb, ts, vals in series]
        _node_scrape(srv, feed, 60_000)
        wm1 = _wait("the second step", lambda: (_group_wm(port) or 0)
                    >= wm0 + 60_000 and _group_wm(port))
        firing = _wait("the webhook's firing alerts", lambda: [
            a for b in posts for a in b["alerts"]
            if a["state"] == "firing" and a["labels"].get("alertname")
            == "SmokeRateUp"])
        out["webhook"] = {"posts": len(posts), "firing": len(firing)}
        code, body, _ = http_get(port, "/api/v1/alerts")
        alerts = json.loads(body)["data"]["alerts"]
        up = [a for a in alerts if a["labels"]["alertname"] == "SmokeRateUp"]
        if code != 200 or not up or any(a["state"] != "firing" for a in up):
            raise AssertionError(f"phase 20: /api/v1/alerts: {body[:300]}")
        code, body, _ = http_get(port, f"/promql/{NODE_DS}/api/v1/rules")
        names = [g["name"] for g in json.loads(body)["data"]["groups"]]
        code2, body2, _ = http_get(port, "/api/v1/rules")
        all_groups = {g["name"] for g in json.loads(body2)["data"]["groups"]}
        if code != 200 or names != ["smoke_60s"] \
                or all_groups != {"smoke_60s", "selfmon_default"}:
            raise AssertionError(f"phase 20: /rules: {names}, {all_groups}")
        code, body, _ = http_get(port, "/api/v1/status/tsdb")
        tsdb = json.loads(body)["data"][NODE_DS]
        code_m, body_m, _ = http_get(port, "/api/v1/status/mesh")
        mesh = json.loads(body_m)["data"][NODE_DS]
        code_i, body_i, _ = http_get(port, "/api/v1/status/ingest")
        lag = json.loads(body_i)["data"].get("rulesWatermarkLagSeconds", {})
        if code != 200 or tsdb["headStats"]["numShards"] != 4 \
                or code_m != 200 or mesh["multiproc"] is not False \
                or code_i != 200 or "smoke_60s" not in lag:
            raise AssertionError(f"phase 20: status routes: {code} {code_m} "
                                 f"{code_i} {lag}")
        out["status"] = {"tsdb_series": tsdb["headStats"]["numSeries"],
                         "mesh": mesh["engine"], "rules_lag_s": lag}
        # an instant query (the extent cache bypasses it): mesh hands it to
        # the sidecar lane, which decodes the edge chunks
        code, body, _ = http_get(port, f"/promql/{NODE_DS}/api/v1/query",
                                 query=RULE_RATE, time=wm1 // 1000,
                                 stats="all")
        qs = json.loads(body)["queryStats"]
        if code != 200 or not qs["decodeMs"] > 0 or not qs["reduceMs"] > 0:
            raise AssertionError(f"phase 20: ?stats=all: {qs}")
        out["stats_all"] = {k: qs[k] for k in ("decodeMs", "reduceMs",
                                               "wallTimeMs")}

        def meta_lag():
            code, body, _ = http_get(port, "/promql/_meta/api/v1/query",
                                     query="max(filodb_ingest_lag_seconds)",
                                     time=int(time.time()))
            res = json.loads(body)["data"]["result"] if code == 200 else []
            return res and float(res[0]["value"][1])

        out["meta_ingest_lag_s"] = _wait("_meta's ingest lag", meta_lag)
        log(f"  over HTTP: /api/v1/rules {sorted(all_groups)}; "
            f"/api/v1/alerts {len(up)} SmokeRateUp firing; the webhook "
            f"{len(posts)} posts, {len(firing)} firing; status/tsdb "
            f"{out['status']['tsdb_series']} series; status/mesh "
            f"{mesh['engine']}; rules lag {lag}; ?stats=all "
            f"{out['stats_all']}; max(filodb_ingest_lag_seconds) from _meta "
            f"{out['meta_ingest_lag_s']:.0f} s")
    finally:
        srv.shutdown()
    srv, out["boot2"] = boot_node(path, dev, "boot 2")
    try:
        port = srv.http.port
        got = _wait("the recovered watermark", lambda: _group_wm(port))
        if got != wm1:
            raise AssertionError(f"phase 20: recovered {got}, want {wm1}")
        _node_scrape(srv, feed, 120_000)
        wm3 = _wait("two more steps", lambda: (_group_wm(port) or 0)
                    >= wm1 + 120_000 and _group_wm(port))
        code, body, _ = http_get(port, f"/promql/{NODE_DS}/api/v1/query_range",
                                 query=f"count_over_time({REC_RATE}[60s])",
                                 start=wm0 // 1000, end=wm3 // 1000, step=60)
        res = json.loads(body)["data"]["result"]
        counts = [float(v) for r in res for _, v in r["values"]]
        steps = (wm3 - wm0) // 60_000 + 1
        if code != 200 or len(res) != 100 \
                or len(counts) != 100 * steps or set(counts) != {1.0}:
            raise AssertionError(f"phase 20: after the restart "
                                 f"count_over_time({REC_RATE}[60s]) over "
                                 f"{steps} steps: {len(res)} series, "
                                 f"{sorted(set(counts))}")
        out["resume"] = {"watermarks": [wm0, wm1, wm3], "steps": steps}
        log(f"  restart: the group resumed at {wm1} and evaluated on to "
            f"{wm3}: one recorded sample a step a namespace over {steps} "
            f"steps (no gap, no double write)")
    finally:
        srv.shutdown()
        hook.shutdown()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  step 2 took {out['seconds']:.1f} s")
    return out


# phase 21: the multi-process mesh runtime. Step 1: ``MP_WORKERS`` worker
# processes on the card, each ingesting the phase-2 generator's series
# that route to its shard slice (``multiproc_store``, spawned at the
# smoke's start so their ingest overlaps the root's), under a runtime
# whose root holds the phase-2 store; ``MP_QUERIES`` at phase 3's grid,
# each bitwise against the root's single-process engine. Step 2: a node
# with ``mesh_workers`` over phase 11's directory.
MP_WORKERS = 2
MP_QUERIES = (
    f"sum(rate({M}[5m])) by (_ns_)",
    f"sum by (job) (rate({M}[5m]))",
    f"avg(rate({M}[10m]))",
    f"sum(sum_over_time({M}[5m])) by (job)",
    f"sum(count_over_time({M}[5m])) by (job)",
)
MP_WARM = 3
MP_SEED = "chip_smoke:multiproc_store"
MP_NODE_QUERY = f"sum(rate({M}[5m])) by (_ns_)"
MP_SCRAPED = 100  # series phase 21's node scrape sends a sample of
MP_NODE_RANGE_S = 900  # its queries' range: the last 15 minutes


def multiproc_store():
    """Phase 21's seed callable, run inside each mesh worker: the phase-2
    store's series that route to the worker's own ``--shards`` (read from
    its command line), with the generator's arguments from
    ``FILODB_SMOKE_SERIES``, ``_SAMPLES`` and ``_SEED``. The generator
    runs over every series, so each kept series is the root's, sample for
    sample, and each shard's partitions come in the root's order."""
    import os

    from filodb_tpu_torch.core.partkey import PartKey

    lo, hi = (int(x) for x in
              sys.argv[sys.argv.index("--shards") + 1].split(":"))
    series = int(os.environ["FILODB_SMOKE_SERIES"])
    samples = int(os.environ["FILODB_SMOKE_SAMPLES"])
    rng = np.random.default_rng(int(os.environ["FILODB_SMOKE_SEED"]))
    store = main_store()
    step = 65536
    for a in range(0, series, step):
        labels, ts, vals = make_series(rng, a, min(a + step, series),
                                       samples)
        own = store.shard_of([PartKey.create("prom-counter", lb)
                              for lb in labels])
        keep = np.flatnonzero((own >= lo) & (own < hi))
        store.ingest_series([labels[i] for i in keep], ts[keep], vals[keep])
    return store


def spawn_multiproc_workers(args, device=None):
    """Phase 21's worker processes, on the card unless ``device`` names
    another; they ingest their slices while the root goes on."""
    import os

    from filodb_tpu_torch.parallel.multiproc import MeshWorkerSupervisor

    path = os.pathsep.join(p for p in (str(ROOT),
                                       os.environ.get("PYTHONPATH")) if p)
    return MeshWorkerSupervisor(
        NODE_DS, 4, MP_WORKERS, seed=MP_SEED, device=device,
        env={"FILODB_SMOKE_SERIES": str(args.series),
             "FILODB_SMOKE_SAMPLES": str(args.samples),
             "FILODB_SMOKE_SEED": str(args.seed),
             "PYTHONPATH": path}).spawn()


def _mp_counts() -> dict:
    from filodb_tpu_torch.coordinator import mesh_cluster as mc

    return {**{f"dispatch_{k}": c.value
               for k, c in mc._M_PROC_DISPATCH.items()},
            **{f"fallback_{k}": c.value
               for k, c in mc._M_PROC_FALLBACK.items()}}


def _mp_delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _mp_counts().items()
            if v != before[k]}


def _bitwise(got, want, what: str) -> None:
    if [str(k) for k in got.keys] != [str(k) for k in want.keys] \
            or np.asarray(got.values).tobytes() \
            != np.asarray(want.values).tobytes():
        raise AssertionError(f"phase 21: {what}: not bitwise the "
                             f"single-process engine's answer")


def multiproc_phase(svc, sup, args) -> dict:
    """Phase 21 step 1 (see the comment above ``MP_WORKERS``): each query
    cold once and warm ``MP_WARM`` times through the runtime and through
    the root's single-process engine, bitwise equal, every one routed
    ``ok``; the workers' launches (B3, and B1/B2/B4, each above 0), device
    bytes and the last collective's seconds; ``FILODB_MULTIPROC=0``
    parity; then one worker killed, and the fallback answer bitwise the
    single-process one with ``fallback{reason="worker"}`` one up."""
    from filodb_tpu_torch.coordinator.mesh_cluster import MeshClusterRuntime
    from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query

    t_phase = time.perf_counter()
    log(f"phase 21, step 1: the multi-process mesh runtime, {MP_WORKERS} "
        f"worker processes on the card under a root over the phase-2 "
        f"store ({args.series} series)")
    t = time.perf_counter()
    sup.wait_ready(timeout_s=SMOKE_TIMEOUT_S)
    out = {"workers": MP_WORKERS, "slices": [list(r) for _, _, r in
                                             sup.slices],
           "ready_wait_s": time.perf_counter() - t, "queries": {}}
    log(f"  workers ready (waited {out['ready_wait_s']:.1f} s more for "
        f"their ingest): slices {out['slices']}")
    rt = MeshClusterRuntime(svc.memstore, NODE_DS, 4, sup.slices,
                            timeout=SMOKE_TIMEOUT_S, device=svc.device)
    start, end = T0_MS // 1000, END_S
    plans = {q: parse_query(q, TimeStepParams(start, 60, end))
             for q in MP_QUERIES}
    answers = {}
    try:
        for q, plan in plans.items():
            times = {}
            before = _mp_counts()
            for side in ("multiproc", "single"):
                runs = []
                for _ in range(1 + MP_WARM):
                    t = time.perf_counter()
                    if side == "multiproc":
                        got = rt.execute_plan(plan)
                        if got is None:
                            raise AssertionError(
                                f"phase 21: {q} fell back: "
                                f"{_mp_delta(before)}")
                        got.materialize()
                    else:
                        res = svc._execute_uncached(plan, wide())
                        if res.stats.engine != "mesh":
                            raise AssertionError(f"phase 21: {q}: the "
                                                 f"root's engine was "
                                                 f"{res.stats.engine}")
                        got = res.result
                    runs.append((time.perf_counter() - t) * 1000.0)
                times[side] = (runs[0], float(np.median(runs[1:])))
                answers[(side, q)] = got
            moved = _mp_delta(before)
            if moved != {"dispatch_ok": 1 + MP_WARM}:
                raise AssertionError(f"phase 21: {q}: counters {moved}")
            _bitwise(answers[("multiproc", q)], answers[("single", q)], q)
            out["queries"][q] = {
                "cold_ms": times["multiproc"][0],
                "warm_p50_ms": times["multiproc"][1],
                "single_first_ms": times["single"][0],
                "single_warm_p50_ms": times["single"][1],
                "rows": answers[("single", q)].num_series,
                "collective_s": rt.last_collective_s}
            log(f"  {q}: multiproc cold {times['multiproc'][0]:.1f} ms, "
                f"warm p50 {times['multiproc'][1]:.2f} ms; single-process "
                f"first {times['single'][0]:.1f} ms, warm p50 "
                f"{times['single'][1]:.2f} ms; {out['queries'][q]['rows']} "
                f"rows, bitwise equal, routed ok; last collective "
                f"{rt.last_collective_s * 1000:.2f} ms")
        st = rt.status()
        launches = {k: sum(w["launches"][k] for w in st["workers"])
                    for k in st["workers"][0]["launches"]}
        out["launches"] = launches
        out["worker_device_bytes"] = [w["device_bytes"]
                                      for w in st["workers"]]
        out["worker_devices"] = [w["devices"] for w in st["workers"]]
        out["last_collective_s"] = st["last_collective_s"]
        card = svc.device.type == "cuda"  # the CPU's plain versions count
        if card and (launches["fused_decode_rate"] <= 0 or not all(
                launches[k] > 0 for k in ("decode_ts_page",
                                          "decode_f32_page",
                                          "windowed_sum"))):
            raise AssertionError(f"phase 21: the workers' launches "
                                 f"{launches}")
        if not all(w["reachable"] and w["devices"] == 1
                   and w["device"].startswith(svc.device.type)
                   for w in st["workers"]):
            raise AssertionError(f"phase 21: worker status {st}")
        log(f"  the workers' launches {launches}; device bytes "
            f"{[b / 1e9 for b in out['worker_device_bytes']]} GB; "
            f"last collective {st['last_collective_s'] * 1000:.2f} ms")
        # FILODB_MULTIPROC=0: the service falls through to its own engine
        svc.mesh_cluster = rt
        before = _mp_counts()
        with valves(FILODB_MULTIPROC="0"):
            for q, plan in plans.items():
                res = svc._execute_uncached(plan, wide())
                if res.stats.engine != "mesh":
                    raise AssertionError(f"phase 21: {q} under "
                                         f"FILODB_MULTIPROC=0: "
                                         f"{res.stats.engine}")
                _bitwise(res.result, answers[("multiproc", q)],
                         f"{q} under FILODB_MULTIPROC=0")
        moved = _mp_delta(before)
        if moved != {"dispatch_fallback": len(plans),
                     "fallback_disabled": len(plans)}:
            raise AssertionError(f"phase 21: FILODB_MULTIPROC=0: {moved}")
        # a lost worker: the fallback answer, bitwise
        sup.procs[0].kill()
        sup.procs[0].wait(timeout=60)
        q = MP_QUERIES[0]
        before = _mp_counts()
        t = time.perf_counter()
        res = svc._execute_uncached(plans[q], wide())
        out["worker_loss_ms"] = (time.perf_counter() - t) * 1000.0
        moved = _mp_delta(before)
        if res.stats.engine != "mesh" or moved != {
                "dispatch_fallback": 1, "fallback_worker": 1}:
            raise AssertionError(f"phase 21: worker loss: "
                                 f"{res.stats.engine}, {moved}")
        _bitwise(res.result, answers[("single", q)], f"{q} after a worker "
                 f"was killed")
        log(f"  FILODB_MULTIPROC=0: {len(plans)} answers bitwise, "
            f"fallback{{reason=\"disabled\"}} +{len(plans)}; worker 0 "
            f"killed: {q} fell back in {out['worker_loss_ms']:.1f} ms, "
            f"bitwise, fallback{{reason=\"worker\"}} +1")
    finally:
        svc.mesh_cluster = None
        rt.shutdown()
        sup.stop()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  step 1 took {out['seconds']:.1f} s")
    return out


def multiproc_node_phase(dev, args) -> dict:
    """Phase 21 step 2: a node over phase 11's directory with
    ``mesh_workers`` (``MP_WORKERS`` workers recovering from its stores and
    tailing its WAL read-only; the extent and response caches off, so each
    HTTP query is evaluated): ``MP_NODE_QUERY`` over HTTP routed ``ok`` once
    the workers have replayed, its body equal to the same node's under
    ``FILODB_MULTIPROC=0``; ``status/mesh`` with ``multiproc: true`` and
    both workers reachable on one device each; then a scrape of
    ``MP_SCRAPED`` series and a query at once (routed, or ``stale`` while
    the workers tail), then routed ``ok`` and equal again."""
    from filodb_tpu_torch.coordinator import mesh_cluster as mc

    t_phase = time.perf_counter()
    log(f"phase 21, step 2: a node with mesh_workers ({MP_WORKERS} "
        f"workers) over phase 11's directory")
    path = node_config(args.durable_dir)
    conf = json.loads(Path(path).read_text())
    conf.update({"mesh_workers": {"enabled": True, "workers": MP_WORKERS,
                                  "ready_timeout_s": 600.0,
                                  "timeout_s": SMOKE_TIMEOUT_S},
                 "result_cache": {"enabled": False},
                 "http_response_cache": False})
    Path(path).write_text(json.dumps(conf))
    out = {}
    srv, out["boot"] = boot_node(path, dev, "phase 21's node")
    try:
        port = srv.http.port
        end = DURABLE_END_S

        def ask():
            code, body, ms = http_get(
                port, f"/promql/{NODE_DS}/api/v1/query_range",
                query=MP_NODE_QUERY, start=end - MP_NODE_RANGE_S, end=end,
                step=60)
            if code != 200:
                raise AssertionError(f"phase 21: HTTP {code}: {body[:300]}")
            return body_data(body), ms

        def routed(what: str, timeout_s: float = 300.0):
            deadline = time.perf_counter() + timeout_s
            tries = []
            while True:
                before = _mp_counts()
                body, ms = ask()
                moved = _mp_delta(before)
                tries.append(moved)
                if moved.get("dispatch_ok"):
                    return body, ms, tries
                if time.perf_counter() > deadline:
                    raise AssertionError(f"phase 21: {what}: not routed in "
                                         f"{timeout_s} s: {tries[-3:]}")
                time.sleep(0.2)

        body, ms, tries = routed("the first query")
        with valves(FILODB_MULTIPROC="0"):
            plain, plain_ms = ask()
        if body != plain:
            raise AssertionError("phase 21: the node's routed body differs "
                                 "from its FILODB_MULTIPROC=0 body")
        out["first"] = {"ms": ms, "single_ms": plain_ms,
                        "tries": len(tries), "before_ok": tries[:-1]}
        code, sbody, _ = http_get(port, "/api/v1/status/mesh")
        mesh = json.loads(sbody)["data"][NODE_DS]
        if code != 200 or mesh["multiproc"] is not True \
                or len(mesh["workers"]) != MP_WORKERS \
                or not all(w["reachable"] and w["devices"] == 1
                           for w in mesh["workers"]):
            raise AssertionError(f"phase 21: status/mesh: {sbody[:600]}")
        out["status"] = {"workers": [{k: w[k] for k in (
            "shards", "device", "devices", "queries", "device_bytes",
            "launches")} for w in mesh["workers"]],
            "last_collective_s": mesh["last_collective_s"]}
        log(f"  routed ok after {len(tries)} tries ({ms:.1f} ms against "
            f"{plain_ms:.1f} ms under FILODB_MULTIPROC=0, bodies equal); "
            f"status/mesh multiproc true, workers {out['status']['workers']}")
        feed = []
        for i in range(MP_SCRAPED):
            lb = {"_metric_": M, "_ws_": "demo", "_ns_": f"App-{i % 100}",
                  "instance": f"instance-{i}", "job": f"job-{i % 10}"}
            feed.append((tuple(sorted(lb.items())), DURABLE_END_S * 1000,
                         1e7))
        _node_scrape(srv, feed, 60_000)
        end = DURABLE_END_S + 60
        before = _mp_counts()
        _, ms = ask()
        out["after_scrape"] = {"ms": ms, "counts": _mp_delta(before)}
        body, ms, tries = routed("the query after the scrape")
        with valves(FILODB_MULTIPROC="0"):
            plain, plain_ms = ask()
        if body != plain:
            raise AssertionError("phase 21: after the scrape the routed "
                                 "body differs from FILODB_MULTIPROC=0's")
        out["tailed"] = {"ms": ms, "single_ms": plain_ms,
                         "tries": len(tries)}
        log(f"  a scrape of {MP_SCRAPED} series, then a query at once: "
            f"{out['after_scrape']['counts']}; routed ok after "
            f"{len(tries)} more tries, equal to FILODB_MULTIPROC=0's")
        out["launches"] = {k: sum(w["launches"][k]
                                  for w in out["status"]["workers"])
                           for k in out["status"]["workers"][0]["launches"]}
    finally:
        srv.shutdown()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  step 2 took {out['seconds']:.1f} s")
    return out


def wide():
    """A QueryContext whose sample limit the smoke's answers fit."""
    from filodb_tpu_torch.query.model import PlannerParams, QueryContext

    return QueryContext(planner_params=PlannerParams(sample_limit=WIDE_LIMIT))


def smoke_service(store, device=None, **kw):
    """A ``QueryService`` whose queries carry ``wide()`` unless they bring
    a context, with the smoke's deadline."""
    if not _SMOKE_SERVICE:
        from filodb_tpu_torch.coordinator.query_service import QueryService

        class SmokeService(QueryService):
            def query_range(self, promql, start, step, end, qcontext=None):
                return super().query_range(promql, start, step, end,
                                           qcontext or wide())

            def query_range_many(self, queries, return_errors=False,
                                 qcontext=None):
                return super().query_range_many(queries, return_errors,
                                                qcontext or wide())

            def _execute_uncached(self, plan, qcontext=None,
                                  materialize=True):
                return super()._execute_uncached(plan, qcontext or wide(),
                                                 materialize)

        _SMOKE_SERVICE.append(SmokeService)
    kw.setdefault("query_timeout_s", SMOKE_TIMEOUT_S)
    return _SMOKE_SERVICE[0](store, device=device, **kw)


def main_store():
    """The phase-2 store: 4 shards, spread 1, 400-sample chunks, and no
    limit on the series an exec leaf matches (``max_query_matches``, the
    reference's 250,000 a shard: phase 10 runs exec over shards of
    250,000 series and more, as the reference's exec would refuse to)."""
    from filodb_tpu_torch.core.memstore.memstore import MemStore
    from filodb_tpu_torch.core.store.config import StoreConfig

    return MemStore(num_shards=4, spread=1, config=StoreConfig(
        max_chunk_size=400, max_query_matches=0))


def run(dev, args):
    """Phases 2-5 on ``dev``; returns the kernels' numbers and the
    phase-2 store's service (phase 7 queries it again)."""
    from filodb_tpu_torch import _build
    from filodb_tpu_torch.http.promjson import matrix_json
    from filodb_tpu_torch.query.engine.aggregations import aggregate

    t = time.perf_counter()
    store = main_store()
    kept = ingest(store, args.series, args.samples, args.seed)
    chunks = sum(len(s.chunks["pid"]) for s in store.shards)
    log(f"phase 2: ingest: {args.series} series, {kept} samples, {chunks} "
        f"sealed chunks, {time.perf_counter() - t:.1f} s on the host")

    svc = smoke_service(store, device=dev)
    start, end = T0_MS // 1000, T0_MS // 1000 + 7200
    _build.reset_counts()
    results, timings = {}, []
    for q, _ in QUERIES:
        t = time.perf_counter()
        r = on_mesh(svc.query_range(q, start, 60, end), q)
        cold = (time.perf_counter() - t) * 1000.0
        warm = []
        for _ in range(args.repeats):
            t = time.perf_counter()
            r = svc.query_range(q, start, 60, end)
            warm.append((time.perf_counter() - t) * 1000.0)
        results[q] = r
        timings.append((q, cold, float(np.median(warm)), r.result.num_series))
    launches = dict(_build.LAUNCHES)
    log("phase 3: main path (query_range, 2 h at 60 s):")
    for q, cold, p50, rows in timings:
        log(f"  {q}: cold {cold:.1f} ms, warm p50 {p50:.2f} ms, {rows} rows")
    log(f"  launches on the main path: {launches}; packed pages on the card: "
        f"{svc.mesh.batch_bytes / 1e9:.2f} GB")
    print(json.dumps({"main_path": window_cache_split(svc, results, timings,
                                                      start, end, args)}))
    missing = [k for k, v in launches.items() if v == 0]
    if missing and dev.type == "cuda":
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    st = results[QUERIES[0][0]].stats
    if st.host_lane or st.precise_lane:
        raise AssertionError("sum(rate) by (_ns_) over integer counters left "
                             "the page lane (the lane gate)")

    log("phase 4: kernels against their plain versions on the card")
    kernels, rate_plain = check_kernels(svc, reps=10)
    for k in kernels:
        k["launches"] = launches[k["name"]]

    log("phase 5: answers")
    q0 = QUERIES[0][0]
    r = results[q0].result
    n_ns = min(100, args.series)
    if r.values.shape != (n_ns, 121) \
            or not np.isfinite(r.values[:, 1:]).all():
        raise AssertionError(f"sum(rate) by (_ns_): shape {r.values.shape}")
    eng = svc.mesh
    batch = max(eng.batches.batches("mesh"), key=lambda b: len(b.keys))
    gids, gkeys = keys_group_ids(eng, lowered(eng, q0, start, end)[1],
                                 batch.out_keys)
    plain = aggregate("sum", rate_plain, gids, len(gkeys)).cpu().numpy()
    order = {str(k): i for i, k in enumerate(gkeys)}
    idx = [order[str(k)] for k in r.keys]
    if not np.allclose(r.values, plain[idx], rtol=1e-5, atol=1e-6,
                       equal_nan=True):
        raise AssertionError("sum(rate) by (_ns_) disagrees with the plain "
                             "path on the card")
    body = matrix_json(results[QUERIES[3][0]])
    if body["status"] != "success" \
            or len(body["data"]["result"]) != min(10, args.series):
        raise AssertionError("count_over_time by job: bad Prometheus body")
    log(f"  sum(rate) by (_ns_): {n_ns} x 121 finite, equal to the plain "
        f"path (rtol 1e-5)")
    small_store_check(args.seed, dev)
    return kernels, svc


def window_cache_split(svc, results: dict, timings: list, start: int,
                       end: int, args) -> dict:
    """Phase 3's warm p50 with the window cache (the default; ``timings``)
    and with ``FILODB_MESH_SPLIT=0`` (the path without the cache), the
    launches of one warm round of each, and the cache's entries and device
    bytes; the answers with and without it must be equal bit for bit."""
    from filodb_tpu_torch import _build

    entries, nbytes = svc.mesh.window_cache
    out = {"cached": {}, "uncached": {}, "entries": entries,
           "device_bytes": nbytes, "batch_bytes": svc.mesh.batch_bytes,
           "budget": svc.batches.budget}
    _build.reset_counts()
    for q, _, p50, _ in timings:
        svc.query_range(q, start, 60, end)
        out["cached"][q] = p50
    out["cached_launches"] = dict(_build.LAUNCHES)
    with valves(FILODB_MESH_SPLIT="0"):
        for q, _, _, _ in timings:
            warm = []
            for i in range(args.repeats):
                if i == args.repeats - 1:
                    _build.reset_counts()
                t = time.perf_counter()
                r = svc.query_range(q, start, 60, end)
                warm.append((time.perf_counter() - t) * 1000.0)
            out.setdefault("uncached_launches", {})[q] = dict(_build.LAUNCHES)
            out["uncached"][q] = float(np.median(warm))
            want = results[q].result
            if r.result.keys != want.keys or not np.array_equal(
                    r.result.values, want.values, equal_nan=True):
                raise AssertionError(f"phase 3: {q}: the window cache's "
                                     f"answer differs from the uncached one")
    if out["cached_launches"]["fused_decode_rate"] \
            or out["cached_launches"]["windowed_sum"]:
        raise AssertionError(f"phase 3: a warm query from the window cache "
                             f"launched B3 or B4: {out['cached_launches']}")
    if svc.batches.nbytes() > svc.batches.budget:
        raise AssertionError("phase 3: the window cache is past the batch "
                             "cache's budget")
    for q in out["cached"]:
        log(f"  {q}: warm p50 {out['cached'][q]:.2f} ms with the window "
            f"cache, {out['uncached'][q]:.2f} ms with FILODB_MESH_SPLIT=0; "
            f"one warm run's launches without it "
            f"{out['uncached_launches'][q]}")
    log(f"  window cache: {entries} entries, {nbytes / 1e9:.3f} GB on the "
        f"card (batches {out['batch_bytes'] / 1e9:.3f} GB, budget "
        f"{out['budget'] / 1e9:.1f} GB); one warm round's launches "
        f"{out['cached_launches']}; answers bit for bit as without it")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--series", type=int, default=1_000_000)
    ap.add_argument("--samples", type=int, default=720)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--long-series", type=int, default=4096)
    ap.add_argument("--long-samples", type=int, default=17_280)
    # phase 8's histograms: cut from 100,000 (then 50,000, 30,000, 20,000)
    # to keep the smoke inside its limit with phases 12, 13, 20 and 21
    # (PERF.md §4)
    ap.add_argument("--hist-series", type=int, default=10_000)
    ap.add_argument("--exec-only", action="store_true",
                    help="build, ingest the phase-2 store and run phase 10 "
                    "only (the exec engine against the mesh engine)")
    ap.add_argument("--durable-series", type=int, default=DURABLE_SERIES)
    ap.add_argument("--durability-only", action="store_true",
                    help="build and run phases 11, 12 and 13 only (their "
                    "own stores: flush, WAL, restart, paged queries, the "
                    "node, eviction and purge)")
    ap.add_argument("--evict-series", type=int, default=EVICT_SERIES)
    ap.add_argument("--ingest-only", action="store_true",
                    help="build, ingest the phase-2 store and run phase 17 "
                    "only (the write path through the C++ ingest core)")
    ap.add_argument("--host-series", type=int, default=HOST_SERIES)
    ap.add_argument("--host-only", action="store_true",
                    help="build and run phase 14 only (the host-decode "
                    "lane)")
    ap.add_argument("--serving-series", type=int, default=SERVING_SERIES)
    ap.add_argument("--serving-only", action="store_true",
                    help="build and run phases 15 and 16 only "
                    "(query_range_many, the extent cache and the query "
                    "control plane, on a store of their own)")
    ap.add_argument("--longterm-series", type=int, default=None,
                    help=f"phase 18's counters ({LT_SERIES}, or "
                    f"{LT_SERIES_ALONE} under --longterm-only), and a "
                    f"quarter as many load averages")
    ap.add_argument("--longterm-only", action="store_true",
                    help="build and run phase 18 only (long retention: the "
                    "downsampler job, the long-time and tiered planners "
                    "over three tiers, and a node)")
    ap.add_argument("--objectstore-series", type=int, default=None,
                    help=f"phase 19's counters ({OS_SERIES}, or "
                    f"{OS_SERIES_ALONE} under --objectstore-only), and a "
                    f"quarter as many load averages")
    ap.add_argument("--objectstore-only", action="store_true",
                    help="build and run phase 19 only (the object-store "
                    "tier: flush to a FakeS3 bucket, a restart from it, the "
                    "tiered and pyramid-lane queries, the approx sketches)")
    ap.add_argument("--multiproc-only", action="store_true",
                    help="build, spawn the mesh workers, ingest the phase-2 "
                    "store and run phase 21 only (the multi-process mesh "
                    "runtime, then phase 11's directory and a node with "
                    "mesh_workers)")
    ap.add_argument("--rules-only", action="store_true",
                    help="build, ingest the phase-2 store and run phases "
                    "11 and 20 only (standing queries over the store, then "
                    "a node with rules, selfmon and a webhook)")
    args = ap.parse_args()
    if args.longterm_series is None:
        args.longterm_series = LT_SERIES_ALONE if args.longterm_only \
            else LT_SERIES
    if args.objectstore_series is None:
        args.objectstore_series = OS_SERIES_ALONE \
            if args.objectstore_only else OS_SERIES

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    if not (ROOT / "filodb_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from the repository root (filodb_tpu_torch "
              "is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from filodb_tpu_torch import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    log(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}"
        f", CUDA {torch.version.cuda}")
    log(f"phase 1: build: {_build.build_all():.1f} s (nvcc, sm_90a, one "
        f"process a source)")
    t = time.perf_counter()
    for name in _build.HOST_SOURCES:
        _build.host_library(name)
    log(f"  host codec and ingest core: {time.perf_counter() - t:.1f} s "
        f"(g++)")
    args.durable_dir = tempfile.mkdtemp(prefix="filodb-durable-")
    free = shutil.disk_usage(args.durable_dir).free
    log(f"  phase 11's store directory {args.durable_dir}: "
        f"{free / 1e9:.1f} GB free")
    try:
        return _phases(args, smi)
    finally:
        shutil.rmtree(args.durable_dir, ignore_errors=True)


def _phases(args, smi) -> int:
    import torch

    from filodb_tpu_torch import _build
    if args.exec_only:

        store = main_store()
        ingest(store, args.series, args.samples, args.seed)
        print(json.dumps({"exec": exec_phase(smoke_service(
            store, device=torch.device("cuda")), args)}))
        print(smi[0] if smi else "nvidia-smi: no output")
        return 0
    if args.ingest_only:
        t = time.perf_counter()
        store = main_store()
        kept = ingest(store, args.series, args.samples, args.seed)
        log(f"phase 2: ingest: {args.series} series, {kept} samples, "
            f"{time.perf_counter() - t:.1f} s on the host")
        print(json.dumps({"ingest_core": ingest_core_phase(smoke_service(
            store, device=torch.device("cuda")), args)}))
        print(smi[0] if smi else "nvidia-smi: no output")
        return 0
    if args.host_only:
        print(json.dumps({"host_lane": host_lane_phase(torch.device("cuda"),
                                                       args)}))
        print(smi[0] if smi else "nvidia-smi: no output")
        return 0
    if args.serving_only:
        serving, svc = serving_phase(torch.device("cuda"), args)
        print(json.dumps({"serving": serving}))
        print(json.dumps({"control_plane": control_plane_phase(svc, args)}))
        print(smi[0] if smi else "nvidia-smi: no output")
        return 0
    if args.longterm_only:
        print(json.dumps({"longterm": longterm_phase(torch.device("cuda"),
                                                     args)}))
        print(smi[0] if smi else "nvidia-smi: no output")
        return 0
    if args.objectstore_only:
        print(json.dumps({"objectstore": objectstore_phase(
            torch.device("cuda"), args)}))
        print(smi[0] if smi else "nvidia-smi: no output")
        return 0
    if args.multiproc_only:
        sup = spawn_multiproc_workers(args)
        try:
            t = time.perf_counter()
            store = main_store()
            kept = ingest(store, args.series, args.samples, args.seed)
            log(f"phase 2: ingest: {args.series} series, {kept} samples, "
                f"{time.perf_counter() - t:.1f} s on the host (the workers "
                f"ingesting their slices beside it)")
            mp = multiproc_phase(smoke_service(
                store, device=torch.device("cuda")), sup, args)
        finally:
            sup.stop()
        print(json.dumps({"multiproc": mp}))
        del store
        torch.cuda.empty_cache()
        durability_phase(torch.device("cuda"), args)
        print(json.dumps({"multiproc_node": multiproc_node_phase(
            torch.device("cuda"), args)}))
        remove_dir(args.durable_dir)
        print(smi[0] if smi else "nvidia-smi: no output")
        return 0
    if args.rules_only:
        t = time.perf_counter()
        store = main_store()
        kept = ingest(store, args.series, args.samples, args.seed)
        log(f"phase 2: ingest: {args.series} series, {kept} samples, "
            f"{time.perf_counter() - t:.1f} s on the host")
        print(json.dumps({"rules": rules_phase(smoke_service(
            store, device=torch.device("cuda")), args)}))
        del store
        torch.cuda.empty_cache()
        durable = durability_phase(torch.device("cuda"), args)
        del durable
        print(json.dumps({"rules_node": rules_node_phase(
            torch.device("cuda"), args)}))
        remove_dir(args.durable_dir)
        print(smi[0] if smi else "nvidia-smi: no output")
        return 0
    if args.durability_only:
        durable, node, _, _ = durable_and_node(torch.device("cuda"), args)
        print(json.dumps({"durability": durable}))
        print(json.dumps({"node": node}))
        torch.cuda.empty_cache()
        print(json.dumps({"eviction": eviction_phase(torch.device("cuda"),
                                                      args)}))
        print(smi[0] if smi else "nvidia-smi: no output")
        return 0
    # phase 21's workers ingest their slices beside phase 2; step 1 runs
    # right after phase 5, when the root holds phase 3's batches only (the
    # card holds the root's and both workers' batches at once) and the
    # store is still phase 2's
    sup = spawn_multiproc_workers(args)
    try:
        kernels, svc = run(torch.device("cuda"), args)
        torch.cuda.empty_cache()
        mp = multiproc_phase(svc, sup, args)
    finally:
        sup.stop()
    print(json.dumps({"multiproc": mp}))
    torch.cuda.empty_cache()
    exec10 = exec_phase(svc, args)
    return _rest(args, smi, kernels, svc, exec10, mp)


def _rest(args, smi, kernels, svc, exec10, mp) -> int:
    """The full smoke after phase 10."""
    import torch

    print(json.dumps({"exec": exec10}))
    torch.cuda.empty_cache()
    longs = long_range(torch.device("cuda"), args, reps=3)
    print(json.dumps({"long_range": longs}))
    torch.cuda.empty_cache()
    promql = promql_phase(svc, args)
    print(json.dumps({"promql": promql}))
    shapes = plan_shapes_phase(svc, args)
    print(json.dumps({"plan_shapes": shapes}))
    # phases 17 and 20 on a store of their own of the phase-2 generator's
    # first CORE_SERIES series (their scale cut for phase 21's room;
    # --ingest-only and --rules-only run them on the 1 M-series store)
    del svc
    torch.cuda.empty_cache()
    t = time.perf_counter()
    store = main_store()
    n = min(CORE_SERIES, args.series)
    kept = ingest(store, n, args.samples, args.seed)
    log(f"phases 17 and 20: their store, the first {n} series of the "
        f"phase-2 generator, {kept} samples, {time.perf_counter() - t:.1f} "
        f"s on the host")
    svc = smoke_service(store, device=torch.device("cuda"))
    keep: dict = {}
    core = ingest_core_phase(svc, args, keep)
    print(json.dumps({"ingest_core": core}))
    rules = rules_phase(svc, args, keep)
    print(json.dumps({"rules": rules}))
    del svc, store, keep
    torch.cuda.empty_cache()
    serving, serving_svc = serving_phase(torch.device("cuda"), args)
    print(json.dumps({"serving": serving}))
    control = control_plane_phase(serving_svc, args)
    print(json.dumps({"control_plane": control}))
    del serving_svc
    torch.cuda.empty_cache()
    durable, node, rules_node, mp_node = durable_and_node(
        torch.device("cuda"), args, rules=True, multiproc=True)
    print(json.dumps({"durability": durable}))
    print(json.dumps({"node": node}))
    print(json.dumps({"rules_node": rules_node}))
    print(json.dumps({"multiproc_node": mp_node}))
    torch.cuda.empty_cache()
    evict = eviction_phase(torch.device("cuda"), args)
    print(json.dumps({"eviction": evict}))
    torch.cuda.empty_cache()
    hist = histogram_phase(torch.device("cuda"), args, reps=5)
    print(json.dumps({"histograms": hist}))
    torch.cuda.empty_cache()
    host = host_lane_phase(torch.device("cuda"), args)
    print(json.dumps({"host_lane": host}))
    torch.cuda.empty_cache()
    longterm = longterm_phase(torch.device("cuda"), args)
    print(json.dumps({"longterm": longterm}))
    torch.cuda.empty_cache()
    objstore = objectstore_phase(torch.device("cuda"), args)
    print(json.dumps({"objectstore": objstore}))
    for kern in kernels:
        kern["launches_phase7"] = promql["launches"][kern["name"]]
        kern["launches_phase8"] = hist["launches"][kern["name"]]
        kern["launches_phase9"] = shapes["launches"][kern["name"]]
        kern["launches_phase10"] = exec10["launches"][kern["name"]]
        kern["launches_phase11"] = durable["launches"][kern["name"]]
        kern["launches_phase12"] = node["launches"][kern["name"]]
        kern["launches_phase13"] = evict["launches"][kern["name"]]
        kern["launches_phase14"] = host["launches"][kern["name"]]
        kern["launches_phase15"] = serving["launches"][kern["name"]]
        kern["launches_phase16"] = control["launches"][kern["name"]]
        kern["launches_phase17"] = core["launches"][kern["name"]]
        kern["launches_phase18"] = longterm["launches"][kern["name"]]
        kern["launches_phase19"] = objstore["launches"][kern["name"]]
        kern["launches_phase20"] = rules["launches"][kern["name"]]
        kern["launches_phase21"] = mp["launches"][kern["name"]]
    print(smi[0] if smi else "nvidia-smi: no output")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {**{k: kern[k] for k in keys},
         **{k: v for k, v in kern.items() if k not in keys}}
        for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
