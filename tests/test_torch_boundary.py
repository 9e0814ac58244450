"""The port stands alone: importing ``filodb_tpu_torch`` and answering a
query loads neither JAX nor any module of the JAX package. Checked in a
fresh interpreter, because this test process imports JAX for every test;
there both are blocked (an import of either raises), and the port's
modules, histograms, absent, count_values, sort, label functions, limit,
scalars, @, subqueries, instant queries and the metadata calls included,
import and answer all the same.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import json, sys
sys.modules["jax"] = None         # any import of these now raises
sys.modules["filodb_tpu"] = None
import numpy as np
import filodb_tpu_torch
from filodb_tpu_torch.coordinator.query_service import QueryService
from filodb_tpu_torch.core.memstore.memstore import MemStore
from filodb_tpu_torch.http.promjson import matrix_json
from filodb_tpu_torch.memory import codecs
from filodb_tpu_torch.query.engine import instantfns
from filodb_tpu_torch.query.exec import binaryjoin, transformers
from filodb_tpu_torch.testing import from_jax

store = MemStore(num_shards=4, spread=1, max_chunk_size=64)
rng = np.random.default_rng(0)
n, T = 12, 150
ts = 1_600_000_000_000 + np.arange(T) * 10_000 + rng.integers(-500, 501, (n, T))
vals = np.cumsum(rng.integers(0, 20, (n, T)), axis=1).astype(float)
labels = [{"_metric_": "http_requests_total", "_ws_": "demo",
           "_ns_": f"App-{i % 2}", "instance": f"i-{i}", "job": f"job-{i % 3}"}
          for i in range(n)]
store.ingest_series(labels, ts, vals)
svc = QueryService(store, device="cpu")
body = matrix_json(svc.query_range(
    "sum(rate(http_requests_total[5m])) by (_ns_)",
    1_600_000_600, 60, 1_600_001_400))
joined = svc.query_range(
    "abs(topk(2, max_over_time(http_requests_total[5m]))) / on (instance) "
    "(http_requests_total * 2) or quantile(0.5, http_requests_total)",
    1_600_000_600, 60, 1_600_001_400)
les = np.array([0.1, 1.0, np.inf])
hist = np.cumsum(np.cumsum(rng.integers(0, 4, (n, T, 3)), axis=2), axis=1)
store.ingest_histograms([{**lb, "_metric_": "lat"} for lb in labels], ts,
                        hist, les)
flat = matrix_json(svc.query_range("sum(rate(lat[5m])) by (_ns_)",
                                   1_600_000_600, 60, 1_600_001_400))
quant = svc.query_range("histogram_quantile(0.9, sum(rate(lat[5m])) by (job))",
                        1_600_000_600, 60, 1_600_001_400)
from filodb_tpu_torch.http.promjson import scalar_json, vector_json
shapes = {}
for q in ('absent(nope{job="x"})', 'count_values("v", http_requests_total % 3)',
          "sort_desc(rate(http_requests_total[5m]))",
          'label_replace(http_requests_total, "j", "$1", "job", "job-(.*)")',
          "limit(2, http_requests_total)", "http_requests_total * time()",
          "scalar(sum(rate(http_requests_total[5m])))", "vector(1) + 1",
          "sum(rate(http_requests_total[5m] @ 1600001000)) by (_ns_)",
          "max_over_time(sum(rate(http_requests_total[5m])) by (_ns_)[10m:1m])"):
    shapes[q] = svc.query_range(q, 1_600_000_600, 60, 1_600_001_400) \
        .result.num_series
inst = vector_json(svc.query_instant("sum(rate(http_requests_total[5m])) "
                                     "by (_ns_)", 1_600_001_400))
scal = scalar_json(svc.query_instant("time()", 1_600_001_400))
from filodb_tpu_torch.promql.parser import TimeStepParams, parse_query
app0 = parse_query('lat{_ns_="App-0"}', TimeStepParams(0, 0, 0)).raw.filters
meta = {"names": svc.label_names(), "jobs": svc.label_values("job"),
        "series": len(svc.series(app0, 1_600_000_000, 1_600_002_000))}
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None
                and (m == "jax" or m.startswith("jax.")
                     or m == "filodb_tpu" or m.startswith("filodb_tpu.")))
print(json.dumps({"series": len(body["data"]["result"]),
                  "joined": joined.result.num_series,
                  "buckets": len(flat["data"]["result"]),
                  "quantiles": quant.result.num_series, "shapes": shapes,
                  "instant": len(inst["data"]["result"]),
                  "scalar": scal["data"]["result"], "meta": meta,
                  "loaded": loaded}))
"""


def test_port_loads_no_jax_and_no_reference_module():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["series"] == 2
    assert res["joined"] > 0
    assert res["buckets"] == 2 * 3
    assert res["quantiles"] == 3
    assert res["shapes"] == {
        'absent(nope{job="x"})': 1,
        'count_values("v", http_requests_total % 3)': 3,
        "sort_desc(rate(http_requests_total[5m]))": 12,
        'label_replace(http_requests_total, "j", "$1", "job", "job-(.*)")':
            12,
        "limit(2, http_requests_total)": 2,
        "http_requests_total * time()": 12,
        "scalar(sum(rate(http_requests_total[5m])))": 1,
        "vector(1) + 1": 1,
        "sum(rate(http_requests_total[5m] @ 1600001000)) by (_ns_)": 2,
        "max_over_time(sum(rate(http_requests_total[5m])) by (_ns_)"
        "[10m:1m])": 2}
    assert res["instant"] == 2
    assert res["scalar"] == [1_600_001_400.0, "1600001400.0"]
    assert res["meta"] == {
        "names": ["_metric_", "_ns_", "_ws_", "instance", "job"],
        "jobs": ["job-0", "job-1", "job-2"], "series": 6}
    assert res["loaded"] == []
