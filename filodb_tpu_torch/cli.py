"""filo-cli: operator command line of the port.

Copy of ``filodb_tpu/cli.py``, every command with its flags and its
output. Counterpart of reference ``cli/src/main/scala/filodb.cli/
CliMain.scala:80,100-115,378`` commands: init / list / status /
indexnames / indexvalues / labelvalues / importcsv / promql execution /
partkey+vector decode debug.

Embedded mode opens the data directory itself (``--store local``: the
sqlite tier under ``<data-dir>/columnstore``, the layout both packages'
nodes write; ``--store object``: the object-store tier): ``init``,
``list``, ``indexnames``, ``labelvalues``, ``importcsv`` (a record a CSV
row, routed and ingested by the shards' C++ pass, then flushed),
``promql`` (index recovery, then the query on the mesh engine, its
chunks paged in from the store), ``validate``, ``topkcard``,
``decodechunks``, ``promfilter-to-partkey`` and ``partkey-as-string``.
Remote mode (``--host``) reads a running node's HTTP API: ``status``,
``tiers``, ``meshstat``, ``lag``, ``shardmap``, ``replicacheck``,
``rules``, ``slowlog``, ``coststats`` and ``promql``.

``--device`` is where ``promql`` runs its kernels: the CUDA card unless
the caller names ``cpu`` (the plain versions), as the node's
``--device``. ``promql --stats`` prints one JSON line to standard error
after the answer: the seconds of index recovery, page-in and the query,
and each kernel's launches.

    python -m filodb_tpu_torch.cli --data-dir data promql \\
        'sum(rate(m[5m]))' --start 1600000000 --end 1600003600
"""

from __future__ import annotations

import argparse
import csv
import json
import sys
import time

import numpy as np

# the reference's schema registry order (``Schemas``), for ``validate``
_SCHEMA_ORDER = ("gauge", "untyped", "prom-counter", "prom-histogram",
                 "ds-gauge")


def _open_stores(args):
    """Open the configured ColumnStore backend (embedded mode): (column
    store, meta store).

    ``--store local`` (default) opens the sqlite tier under
    ``data_dir/columnstore``; ``--store object`` opens the S3-compatible
    segment tier (``--endpoint`` http(s)://… for a real service, else a
    directory-backed fake under ``data_dir/objectstore``)."""
    import os

    if args.store == "object":
        from filodb_tpu_torch.core.store.objectstore import open_object_store
        return open_object_store({"endpoint": args.endpoint,
                                  "bucket": args.bucket}, args.data_dir)
    from filodb_tpu_torch.core.store.localstore import (
        LocalDiskColumnStore,
        LocalDiskMetaStore,
    )
    root = os.path.join(args.data_dir, "columnstore")
    return LocalDiskColumnStore(root), LocalDiskMetaStore(root)


def _memstore(args, cs, meta):
    """The dataset's store over the opened tiers, at the reference's
    default store config."""
    from filodb_tpu_torch.core.memstore.memstore import MemStore
    from filodb_tpu_torch.core.store.config import StoreConfig

    return MemStore(args.num_shards, args.spread, column_store=cs,
                    meta_store=meta, config=StoreConfig(),
                    dataset=args.dataset)


def _recovered(args):
    """The dataset's store with every shard's index recovered, and the
    seconds that took."""
    cs, meta = _open_stores(args)
    ms = _memstore(args, cs, meta)
    t = time.perf_counter()
    for shard in range(args.num_shards):
        ms.recover_index(shard)
    return ms, time.perf_counter() - t


def _get_json(args, path: str):
    import urllib.request
    with urllib.request.urlopen(f"http://{args.host}{path}") as r:
        return json.load(r)


def cmd_init(args):
    cs, _ = _open_stores(args)
    cs.initialize(args.dataset, args.num_shards)
    print(f"initialized dataset {args.dataset} with {args.num_shards} shards")


def cmd_list(args):
    cs, _ = _open_stores(args)
    total = 0
    for shard in range(args.num_shards):
        recs = cs.scan_part_keys(args.dataset, shard)
        total += len(recs)
        for r in recs[: args.limit]:
            print(f"shard={shard} {r.part_key} "
                  f"[{r.start_time}, {r.end_time}]")
    print(f"total partitions: {total}")


def cmd_status(args):
    import urllib.error
    print(json.dumps(_get_json(
        args, f"/api/v1/cluster/{args.dataset}/status"), indent=2))
    # TSDB head/cardinality summary (``/api/v1/status/tsdb``); older
    # servers without the route still answer the cluster status above
    try:
        doc = _get_json(args, f"/api/v1/status/tsdb?dataset={args.dataset}"
                              f"&topk={args.k}")["data"].get(args.dataset)
    except urllib.error.HTTPError:
        return
    if not doc:
        return
    head = doc["headStats"]
    print(f"\nhead: series={head['numSeries']} shards={head['numShards']}")
    print(f"{'SHARD':>5} {'SERIES':>8} {'INDEX_RAM':>10} {'ENC_BYTES':>10} "
          f"{'CHUNKS_FLUSHED':>14}")
    for s in doc["shards"]:
        print(f"{s['shard']:>5} {s['numSeries']:>8} "
              f"{s['indexRamBytes']:>10} {s['encodedBytes']:>10} "
              f"{s['chunksFlushed']:>14}")
    print("\ntop metrics by active series:")
    for m in doc["seriesCountByMetricName"]:
        print(f"  {m['name']:<40} {m['value']:>8}")
    print("top labels by distinct values:")
    for m in doc["labelValueCountByLabelName"]:
        print(f"  {m['name']:<40} {m['value']:>8}")


def cmd_tiers(args):
    """Retention-tier map for a dataset (``/api/v1/status/tiers``): which
    tiers answer queries (memstore / downsample / objectstore), their time
    floors, and per-tier series/bytes."""
    d = _get_json(args, f"/api/v1/status/tiers?dataset={args.dataset}")[
        "data"]
    doc = d.get(args.dataset)
    if doc is None:
        print(f"unknown dataset {args.dataset}")
        return 1
    if args.json:
        print(json.dumps(doc, indent=2))
        return 0
    print(f"dataset={args.dataset} federated={doc['federated']}")
    for k in ("memFloorMs", "rawFloorMs"):
        if doc.get(k) is not None:
            print(f"{k}: {doc[k]}")
    print(f"\n{'TIER':<12} {'SERIES':>9} {'BYTES':>12} {'DETAIL'}")
    for t in doc["tiers"]:
        extra = " ".join(
            f"{k}={t[k]}" for k in ("segments", "resolutionMs")
            if t.get(k) is not None)
        print(f"{t['tier']:<12} {str(t.get('series', '-')):>9} "
              f"{str(t.get('bytes', '-')):>12} {extra}")
    return 0


def cmd_meshstat(args):
    """Multi-process mesh runtime one-pager: per-worker mesh slice,
    reachability/breaker state, device count, descriptor-cache occupancy,
    and the last root-side collective latency
    (``/api/v1/status/mesh``)."""
    d = _get_json(args, "/api/v1/status/mesh")["data"]
    if args.json:
        print(json.dumps(d, indent=2))
        return 0
    for ds, doc in d.items():
        if not doc.get("multiproc"):
            eng = doc.get("engine")
            extra = (f" engine: hits={eng['hits']} misses={eng['misses']} "
                     f"programs={eng['programs']}" if eng else "")
            print(f"dataset={ds} multiproc=off{extra}")
            continue
        coll = doc.get("last_collective_s")
        print(f"dataset={ds} multiproc=on enabled={doc['enabled']} "
              f"shards={doc['num_shards']} "
              f"last_collective_s="
              f"{'-' if coll is None else f'{coll:.4f}'}")
        print(f"{'WORKER':<22} {'SHARDS':>9} {'UP':>3} {'BREAKER':>9} "
              f"{'DEVS':>5} {'DESCCACHE':>9} {'QUERIES':>8} "
              f"{'LAST_EXEC_S':>11}")
        for w in doc.get("workers", []):
            lo, hi = w.get("shards", [0, 0])
            last = w.get("last_exec_s")
            print(f"{w['peer']:<22} {f'{lo}:{hi}':>9} "
                  f"{('y' if w.get('reachable') else 'n'):>3} "
                  f"{w.get('breaker', '?'):>9} "
                  f"{str(w.get('devices', '-')):>5} "
                  f"{str(w.get('descriptor_cache', '-')):>9} "
                  f"{str(w.get('queries', '-')):>8} "
                  f"{('-' if last is None else f'{last:.4f}'):>11}")
    return 0


def cmd_lag(args):
    """Ingest freshness one-pager: per-shard lag vs wall clock, replay-log
    offset/checkpoint lag, write-behind queue state, and rules watermark
    lag (``/api/v1/status/ingest``)."""
    d = _get_json(args, "/api/v1/status/ingest")["data"]
    if args.json:
        print(json.dumps(d, indent=2))
        return
    print(f"{'DATASET':<14} {'SHARD':>5} {'LAG_S':>8} {'OFFSET':>8} "
          f"{'LOG_LATEST':>10} {'OFF_LAG':>8} {'CKPT_LAG':>8}")
    for ds, doc in d["datasets"].items():
        for s in doc["shards"]:
            lag = s.get("ingestLagSeconds")
            print(f"{ds:<14} {s['shard']:>5} "
                  f"{('-' if lag is None else f'{lag:.1f}'):>8} "
                  f"{s['ingestedOffset']:>8} "
                  f"{str(s.get('logLatestOffset', '-')):>10} "
                  f"{str(s.get('offsetLag', '-')):>8} "
                  f"{str(s.get('checkpointLag', '-')):>8}")
    ob = d.get("objectstore", {})
    print(f"\nobjectstore: queue_depth={ob.get('queueDepth')} "
          f"oldest_task_age_s={ob.get('oldestTaskAgeSeconds', 0):.1f}")
    if "gatewayQueueDepth" in d:
        print(f"gateway: queue_depth={d['gatewayQueueDepth']}")
    for group, lag in sorted(d.get("rulesWatermarkLagSeconds",
                                   {}).items()):
        print(f"rules[{group}]: watermark_lag_s={lag:.1f}")
    slow = d.get("slowIngest", [])
    if slow:
        print(f"\nslow ingest operations (newest {len(slow)}):")
        for e in slow:
            print(f"  {e.get('kind', '?'):<12} "
                  f"{e.get('duration_ms', 0):>9.1f}ms "
                  + " ".join(f"{k}={e[k]}"
                             for k in ("dataset", "shard", "group", "op")
                             if e.get(k) is not None))


def cmd_shardmap(args):
    """Shard map with migration phases + per-tenant quota usage: one table
    answering "where is every shard, is anything moving, and which tenants
    are near their limits" (``/api/v1/cluster/{dataset}/shardmap``)."""
    doc = _get_json(args, f"/api/v1/cluster/{args.dataset}/shardmap")[
        "data"]
    print(f"{'SHARD':>5}  {'NODE':<16} {'STATUS':<10} {'WM':>8} "
          f"{'MIGRATION':<24} REPLICAS")
    for entry in doc.get("shards", []):
        mig = entry.get("migration")
        migs = (f"{mig['phase']} {mig['source']}->{mig['dest']} "
                f"lag={mig['lag']}" if mig else "-")
        reps = " ".join(
            f"{r['node']}:{r['status']}@{r.get('watermark', -1)}"
            for r in entry.get("replicas", [])) or "-"
        print(f"{entry['shard']:>5}  {str(entry.get('node')):<16} "
              f"{entry.get('status', '?'):<10} "
              f"{str(entry.get('watermark', '-')):>8} {migs:<24} {reps}")
    tenants = doc.get("tenants", [])
    if tenants:
        print(f"\n{'TENANT':<24} {'SERIES':>10} {'QUOTA':>10} "
              f"{'MAX_INFLIGHT':>12}")
        for t in tenants:
            quota = t["max_series"] or "-"
            infl = t["max_inflight"] or "-"
            print(f"{t['tenant']:<24} {t['active_series']:>10} "
                  f"{str(quota):>10} {str(infl):>12}")


def cmd_replicacheck(args):
    """Replica-divergence detector: compare each shard's leader watermark
    against its followers' applied offsets over the shardmap API; a
    follower trailing by more than ``--max-lag`` (or an IN_SYNC follower
    with no watermark at all) is a divergence and the command exits 1."""
    doc = _get_json(args, f"/api/v1/cluster/{args.dataset}/shardmap")[
        "data"]
    divergent = 0
    checked = 0
    print(f"{'SHARD':>5}  {'LEADER':<16} {'WM':>8}  "
          f"{'FOLLOWER':<16} {'STATUS':<10} {'WM':>8}  VERDICT")
    for entry in doc.get("shards", []):
        leader_wm = entry.get("watermark")
        for rep in entry.get("replicas", []):
            checked += 1
            rep_wm = rep.get("watermark", -1)
            if rep["status"] != "in_sync":
                verdict = f"skip ({rep['status']})"
            elif leader_wm is None:
                verdict = "skip (no leader watermark)"
            elif leader_wm - rep_wm > args.max_lag:
                verdict = f"DIVERGED (lag {leader_wm - rep_wm})"
                divergent += 1
            else:
                verdict = "ok"
            print(f"{entry['shard']:>5}  {str(entry.get('node')):<16} "
                  f"{str(leader_wm):>8}  {rep['node']:<16} "
                  f"{rep['status']:<10} {rep_wm:>8}  {verdict}")
    print(f"\n{checked} replica(s) checked, {divergent} divergent")
    return 1 if divergent else 0


def cmd_rules(args):
    """Standing-query status: every rule group's watermark plus per-rule
    health, and all active alerts with their state/activation time
    (``/api/v1/rules`` + ``/api/v1/alerts``)."""
    groups = _get_json(args, "/api/v1/rules")["data"]["groups"]
    if not groups:
        print("no rule groups configured")
        return
    for g in groups:
        wm = g.get("watermark")
        print(f"group {g['name']} dataset={g['dataset']} "
              f"interval={g['interval']}s watermark={wm if wm else '-'}")
        for rule in g.get("rules", []):
            print(f"  {rule['type']:<9} {rule['name']:<28} "
                  f"health={rule['health']:<8} {rule['query']}")
            if rule.get("lastError"):
                print(f"            lastError: {rule['lastError']}")
    alerts = _get_json(args, "/api/v1/alerts")["data"]["alerts"]
    print(f"\n{'ALERT':<28} {'STATE':<8} {'ACTIVE_AT':<26} LABELS")
    for a in alerts:
        labels = ",".join(f"{k}={v}" for k, v in sorted(a["labels"].items())
                          if k != "alertname")
        print(f"{a['labels'].get('alertname', '?'):<28} {a['state']:<8} "
              f"{a['activeAt']:<26} {labels}")
    if not alerts:
        print("(no active alerts)")


def cmd_slowlog(args):
    """Slow-query flight recorder dump: every query (or traced operation)
    that exceeded ``slow_query_threshold_ms``, newest first, with merged
    stats and — when sampled — the full distributed span tree
    (``/promql/{dataset}/api/v1/debug/slow_queries``)."""
    import datetime as dt

    qs = f"?limit={args.limit}" if args.limit else ""
    entries = _get_json(args, f"/promql/{args.dataset}/api/v1/debug/"
                              f"slow_queries{qs}")["data"]["slow_queries"]
    if not entries:
        print("(flight recorder empty)")
        return
    if args.json:
        print(json.dumps(entries, indent=2))
        return
    for e in entries:
        when = dt.datetime.fromtimestamp(e.get("when", 0)) \
            .strftime("%Y-%m-%d %H:%M:%S")
        head = (f"{when}  {e.get('kind', 'query'):<10} "
                f"{e.get('duration_ms', 0):>9.1f}ms "
                f"sampled={str(e.get('sampled', False)).lower()}")
        if e.get("query"):
            head += f"  {e['query']}"
        print(head)
        for k in ("dataset", "group", "phase", "op"):
            if e.get(k):
                print(f"    {k}={e[k]}")
        stats = e.get("stats") or {}
        if stats:
            print("    stats: " + " ".join(
                f"{k}={v}" for k, v in sorted(stats.items()) if v))
        for s in e.get("spans", []):
            tags = " ".join(f"{k}={v}"
                            for k, v in sorted((s.get("tags") or {}).items()))
            print(f"    {'  ' * s.get('depth', 0)}"
                  f"{s['name']} {s.get('duration_ms', 0):.3f}ms"
                  + (f" [{tags}]" if tags else ""))


def cmd_coststats(args):
    """Adaptive-planner cost model dump: per-(site, signature, arm) online
    estimates with warm state, per-site calibration error, and recent
    predicted-vs-actual pairs
    (``/promql/{dataset}/api/v1/debug/costmodel``)."""
    qs = f"?limit={args.limit}" if args.limit else ""
    snap = _get_json(args, f"/promql/{args.dataset}/api/v1/debug/"
                           f"costmodel{qs}")["data"]
    if args.json:
        print(json.dumps(snap, indent=2))
        return
    print(f"dataset={snap['dataset']} adaptive="
          f"{'on' if snap['enabled'] else 'off'} "
          f"signatures={snap['signatures']}/{snap['max_signatures']} "
          f"min_samples={snap['min_samples']}")
    calib = snap.get("calibration_error") or {}
    if calib:
        print("calibration error (EWMA |pred-actual|/actual):")
        for site, err in sorted(calib.items()):
            print(f"    {site:<10} {err:.3f}")
    rows = snap.get("estimates") or []
    if not rows:
        print("(no observations yet)")
        return
    print(f"{'site':<10} {'signature':<32} {'arm':<10} {'n':>5} "
          f"{'est_s':>10} {'p50_s':>10} {'p90_s':>10} warm")
    for row in rows:
        p50 = row["p50_s"]
        p90 = row["p90_s"]
        print(f"{row['site']:<10} {row['signature']:<32.32} "
              f"{row['arm']:<10} {row['n']:>5} {row['estimate_s']:>10.6f} "
              f"{p50 if p50 is None else format(p50, '10.6f')} "
              f"{p90 if p90 is None else format(p90, '10.6f')} "
              f"{'yes' if row['warm'] else 'no'}")


def cmd_indexnames(args):
    ms, _ = _recovered(args)
    print("\n".join(ms.label_names()))


def cmd_labelvalues(args):
    ms, _ = _recovered(args)
    print("\n".join(ms.label_values(args.label)))


def cmd_importcsv(args):
    """CSV: timestamp_ms,value,label1=value1,label2=value2,..."""
    from filodb_tpu_torch.coordinator.ingestion import ingest_routed
    from filodb_tpu_torch.core.partkey import METRIC_LABEL, PartKey
    from filodb_tpu_torch.core.record import (
        IngestRecord,
        RecordContainer,
        SomeData,
    )

    cs, meta = _open_stores(args)
    ms = _memstore(args, cs, meta)
    for shard in range(args.num_shards):
        ms.recover_index(shard)
        ms.recovery_start_offset(shard)
    container = RecordContainer()
    n = 0
    keys: dict[tuple, PartKey] = {}  # one key a label set, its hashes once
    with open(args.file) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            ts, value = int(row[0]), float(row[1])
            pk = keys.get(tuple(row[2:]))
            if pk is None:
                labels = {METRIC_LABEL: args.metric}
                for pair in row[2:]:
                    k, v = pair.split("=", 1)
                    labels[k] = v
                pk = keys[tuple(row[2:])] = PartKey.create("gauge", labels)
            container.add(IngestRecord(pk, ts, (value,)))
            n += 1
            if len(container) >= 1000:
                ingest_routed(ms, [SomeData(container, n)])
                container = RecordContainer()
    if len(container):
        ingest_routed(ms, [SomeData(container, n)])
    ms.flush_all()
    # drain write-behind uploads (object store) before the process exits
    ms.close()
    print(f"imported {n} samples")


def cmd_promql(args):
    if args.host:
        import urllib.parse
        qs = urllib.parse.urlencode({
            "query": args.promql, "start": args.start, "end": args.end,
            "step": args.step})
        print(json.dumps(_get_json(
            args, f"/promql/{args.dataset}/api/v1/query_range?{qs}"),
            indent=2))
        return
    from filodb_tpu_torch import _build
    from filodb_tpu_torch.coordinator.query_service import QueryService
    from filodb_tpu_torch.http.promjson import matrix_json

    ms, index_s = _recovered(args)
    svc = QueryService(ms, device=args.device)
    _build.reset_counts()
    t = time.perf_counter()
    r = svc.query_range(args.promql, args.start, args.step, args.end)
    body = matrix_json(r)
    answer_s = time.perf_counter() - t
    print(json.dumps(body, indent=2))
    if args.stats:
        print(json.dumps({"index_recovery_s": index_s,
                          "page_in_s": sum(sum(sh.odp_cache.seconds.values())
                                           for sh in ms.shards),
                          "answer_s": answer_s,
                          "launches": dict(_build.LAUNCHES)}),
              file=sys.stderr, flush=True)


def cmd_validate(args):
    """Validate schema definitions (reference ``validateSchemas`` command)."""
    from filodb_tpu_torch.core.schemas import SCHEMAS

    ids = {}
    for name in _SCHEMA_ORDER:
        s = SCHEMAS[name]
        if ids.setdefault(s.schema_id, name) != name:
            print(f"schema id clash: {name} and {ids[s.schema_id]}",
                  file=sys.stderr)
            return 1
        cols = ", ".join(f"{c.name}:{c.ctype.value}"
                         + ("(counter)" if c.is_counter else "")
                         for c in s.data.columns)
        ds = f" -> {s.data.downsample_schema}" if s.data.downsample_schema \
            else ""
        print(f"{s.name} (id={s.schema_id}): {cols}{ds}")
        if s.data.downsamplers:
            print(f"  downsamplers: {', '.join(s.data.downsamplers)}")
    print(f"{len(_SCHEMA_ORDER)} schemas OK (no id clashes)")
    return 0


def cmd_topkcard(args):
    """Top-k cardinality under a shard-key prefix (reference ``topkcard``):
    counts persisted part keys grouped by the next shard-key level."""
    from collections import Counter

    cs, _ = _open_stores(args)
    prefix = [p for p in (args.prefix or "").split("/") if p]
    labels = ("_ws_", "_ns_", "_metric_")
    counts = Counter()
    for shard in range(args.num_shards):
        for rec in cs.scan_part_keys(args.dataset, shard):
            lm = rec.part_key.label_map
            path = [lm.get(k, "") for k in labels]
            if path[: len(prefix)] == prefix:
                child = (path[len(prefix)] if len(prefix) < len(path)
                         else path[-1])
                counts[child] += 1
    for name, n in counts.most_common(args.k):
        print(f"{name}\tseries={n}")


def cmd_decode_chunk(args):
    """Debug: decode and dump a partition's chunk info + samples (reference
    ``decodeChunkInfo`` / ``decodeVector`` commands)."""
    from filodb_tpu_torch.memory.chunk import Chunk
    from filodb_tpu_torch.memory.codecs import HistogramColumn

    cs, _ = _open_stores(args)
    for shard in range(args.num_shards):
        for rec in cs.scan_part_keys(args.dataset, shard):
            if args.filter and args.filter not in str(rec.part_key):
                continue
            chunks = sorted((Chunk.deserialize(d) for _, d in
                             cs.read_chunk_rows(
                                 args.dataset, shard,
                                 [rec.part_key.serialized], 0, 2**62)),
                            key=lambda c: c.id)
            print(f"partition {rec.part_key} shard={shard}: "
                  f"{len(chunks)} chunks")
            for c in chunks[: args.limit]:
                print(f"  chunk id={c.id} rows={c.num_rows} "
                      f"[{c.start_time}..{c.end_time}] bytes={c.nbytes}")
                if args.verbose:
                    ts = c.decode_column(0)
                    print(f"    ts[:5]={ts[:5]}")
                    for ci in range(1, len(c.vectors)):
                        vals = c.decode_column(ci)
                        codec_id = c.vectors[ci][0]
                        if isinstance(vals, HistogramColumn):
                            print(f"    col{ci} codec={codec_id} hist "
                                  f"les={vals.les} rows[:2]={vals.rows[:2]}")
                        elif isinstance(vals, list):  # strings or maps
                            print(f"    col{ci} codec={codec_id} "
                                  f"vals[:5]={vals[:5]}")
                        else:
                            print(f"    col{ci} codec={codec_id} "
                                  f"vals[:5]={np.asarray(vals)[:5]}")


def cmd_promfilter_to_partkey(args):
    """Forensics: turn a PromQL series selector into the part-key bytes the
    ingestion path would produce (reference ``CliMain.scala:100-108``
    ``promFilterToPartKeyBR``), plus its hashes and owning shard.  With
    ``--lookup``, scans the opened ColumnStore (any backend, including the
    object store) for persisted part keys matching the filter."""
    from filodb_tpu_torch.core.partkey import (
        METRIC_LABEL,
        PartKey,
        ingestion_shard,
    )
    from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query

    raw = parse_query(args.promfilter, TimeStepParams(0, 60, 0))
    while not hasattr(raw, "filters"):
        raw = raw.raw
    labels = {}
    for f in raw.filters:
        cond = f.filter
        if type(cond).__name__ != "Equals":
            print(f"error: only equality filters map to a part key "
                  f"(got {type(cond).__name__} on {f.column})",
                  file=sys.stderr)
            return 1
        labels[f.column] = cond.value
    if METRIC_LABEL not in labels:
        print("error: selector needs a metric name", file=sys.stderr)
        return 1
    pk = PartKey.create(args.schema, labels)
    skh = pk.shard_key_hash(("_ws_", "_ns_", METRIC_LABEL))
    shard = ingestion_shard(skh, pk.part_hash, args.num_shards, args.spread)
    print(f"partKey      {pk}")
    print(f"schema       {pk.schema}")
    print(f"bytes (hex)  {pk.serialized.hex()}")
    print(f"partHash     {pk.part_hash:#010x}")
    print(f"shardKeyHash {skh:#010x}")
    print(f"shard        {shard}  (numShards={args.num_shards} "
          f"spread={args.spread})")
    if args.lookup:
        cs, _ = _open_stores(args)
        want = set(labels.items())
        hits = 0
        for sh in range(args.num_shards):
            for rec in cs.scan_part_keys(args.dataset, sh):
                if want <= set(rec.part_key.labels):
                    hits += 1
                    print(f"  persisted shard={sh} {rec.part_key} "
                          f"[{rec.start_time}, {rec.end_time}]")
        print(f"  {hits} persisted partition(s) match")
    return 0


def cmd_partkey_as_string(args):
    """Forensics: decode serialized part-key bytes (hex) back to a readable
    key (reference ``CliMain.scala:110-115`` ``partKeyBrAsString``)."""
    from filodb_tpu_torch.core.partkey import METRIC_LABEL, ingestion_shard
    from filodb_tpu_torch.core.store.api import pk_from_blob

    try:
        blob = bytes.fromhex(args.hexkey.strip().removeprefix("0x"))
        pk = pk_from_blob(blob)
    except ValueError as e:
        print(f"error: not a valid part-key blob: {e}", file=sys.stderr)
        return 1
    skh = pk.shard_key_hash(("_ws_", "_ns_", METRIC_LABEL))
    print(f"partKey      {pk}")
    print(f"schema       {pk.schema}")
    for k, v in pk.labels:
        print(f"  {k} = {v}")
    print(f"partHash     {pk.part_hash:#010x}")
    print(f"shardKeyHash {skh:#010x}")
    print(f"shard        "
          f"{ingestion_shard(skh, pk.part_hash, args.num_shards, args.spread)}"
          f"  (numShards={args.num_shards} spread={args.spread})")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="filo-cli")
    ap.add_argument("--data-dir", default="./filodb-data")
    ap.add_argument("--dataset", default="timeseries")
    ap.add_argument("--num-shards", type=int, default=4)
    ap.add_argument("--spread", type=int, default=1)
    ap.add_argument("--host", default=None,
                    help="host:port of a running server (remote mode)")
    ap.add_argument("--store", choices=("local", "object"), default="local",
                    help="ColumnStore backend to open in embedded mode")
    ap.add_argument("--endpoint", default=None,
                    help="object-store endpoint (http(s)://… for S3, "
                         "else a local directory)")
    ap.add_argument("--bucket", default="filodb")
    ap.add_argument("--device", default=None,
                    help="where promql runs: cuda (the default) or cpu")
    sub = ap.add_subparsers(dest="command", required=True)

    sub.add_parser("init")
    p = sub.add_parser("list")
    p.add_argument("--limit", type=int, default=20)
    p = sub.add_parser("status")
    p.add_argument("-k", type=int, default=10,
                   help="top-k cardinality entries in the TSDB summary")
    p = sub.add_parser("lag")
    p.add_argument("--json", action="store_true",
                   help="raw JSON instead of the formatted table")
    p = sub.add_parser("tiers")
    p.add_argument("--json", action="store_true",
                   help="raw JSON instead of the formatted table")
    p = sub.add_parser("meshstat")
    p.add_argument("--json", action="store_true",
                   help="raw JSON instead of the formatted table")
    sub.add_parser("shardmap")
    p = sub.add_parser("replicacheck")
    p.add_argument("--max-lag", type=int, default=0,
                   help="offsets a follower may trail the leader by")
    sub.add_parser("rules")
    p = sub.add_parser("slowlog")
    p.add_argument("--limit", type=int, default=0,
                   help="newest N entries (0 = everything retained)")
    p.add_argument("--json", action="store_true",
                   help="raw JSON instead of the formatted table")
    p = sub.add_parser("coststats")
    p.add_argument("--limit", type=int, default=0,
                   help="top N estimate rows (0 = everything retained)")
    p.add_argument("--json", action="store_true",
                   help="raw JSON instead of the formatted table")
    sub.add_parser("indexnames")
    p = sub.add_parser("labelvalues")
    p.add_argument("label")
    p = sub.add_parser("importcsv")
    p.add_argument("file")
    p.add_argument("--metric", required=True)
    p = sub.add_parser("promql")
    p.add_argument("promql")
    p.add_argument("--start", type=int, required=True)
    p.add_argument("--end", type=int, required=True)
    p.add_argument("--step", type=int, default=60)
    p.add_argument("--stats", action="store_true",
                   help="timings and kernel launches, one JSON line on "
                        "standard error")
    p = sub.add_parser("decodechunks")
    p.add_argument("--filter", default=None)
    p.add_argument("--limit", type=int, default=5)
    p.add_argument("--verbose", action="store_true")
    p = sub.add_parser("topkcard")
    p.add_argument("--prefix", default="", help="ws or ws/ns")
    p.add_argument("-k", type=int, default=10)
    sub.add_parser("validate")
    p = sub.add_parser("promfilter-to-partkey")
    p.add_argument("promfilter", help='e.g. \'heap_usage{_ws_="demo"}\'')
    p.add_argument("--schema", default="gauge")
    p.add_argument("--lookup", action="store_true",
                   help="scan the store for matching persisted part keys")
    p = sub.add_parser("partkey-as-string")
    p.add_argument("hexkey", help="serialized part-key bytes, hex")

    args = ap.parse_args(argv)
    return {"init": cmd_init, "list": cmd_list, "status": cmd_status,
            "lag": cmd_lag, "tiers": cmd_tiers, "meshstat": cmd_meshstat,
            "shardmap": cmd_shardmap, "replicacheck": cmd_replicacheck,
            "rules": cmd_rules,
            "slowlog": cmd_slowlog,
            "coststats": cmd_coststats,
            "indexnames": cmd_indexnames, "labelvalues": cmd_labelvalues,
            "importcsv": cmd_importcsv, "promql": cmd_promql,
            "decodechunks": cmd_decode_chunk, "topkcard": cmd_topkcard,
            "validate": cmd_validate,
            "promfilter-to-partkey": cmd_promfilter_to_partkey,
            "partkey-as-string": cmd_partkey_as_string,
            }[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
