"""filolint over the port — concurrency-discipline and invariant static
analysis of ``filodb_tpu_torch/``.

Copy of ``filodb_tpu/analysis``, every path aimed at the port's tree
(the reference's analyser names its own files and stays as it is).

Passes (each a ``run(ctx) -> list[Finding]`` module):

- :mod:`~filodb_tpu_torch.analysis.lockdiscipline` — per-class lock
  graphs from ``with self._lock:`` scopes; blocking calls under a held
  lock (LD101), statically-approximated lock-order cycles (LD102), and
  attributes mutated both under and outside any lock (LD103).
- :mod:`~filodb_tpu_torch.analysis.lifecycle` — interprocedural resource
  lifecycle: leak-on-exception (RL401), never-released (RL402),
  non-daemon thread never joined (RL403), queue ack outside finally
  (RL404).
- :mod:`~filodb_tpu_torch.analysis.chokepoint` — whole-repo choke-point
  proofs: dispatch without a deadline (CP501), query execution outside
  governor admission (CP502), breaker bookkeeping outside resilience.py
  (CP503), double outcome in one ``calling()`` path (CP504).
- :mod:`~filodb_tpu_torch.analysis.parity` — wire-registry closure over
  the port's ``coordinator/wire.py`` (PR201/2), ``filodb_*`` metric name
  parity with the reference's scrape test's expected lists, read as
  source (PR203/4), Prometheus name charset (PR205).
- :mod:`~filodb_tpu_torch.analysis.hotpath` — host syncs and wall-clock
  or randomness inside the port's device programs (HP301/2): the
  functions ``parallel/dist_query.py``'s factories return, a
  ``torch.autograd.Function``'s ``forward`` / ``backward``, ``@triton.jit``
  functions.
- :mod:`~filodb_tpu_torch.analysis.decisionparity` — every
  ``cost_model.decide()``/``classify()`` site settles its decision or
  returns it to a caller that does (DC601).

Findings diff against ``conf/filolint_torch_baseline.json``, whose every
entry names its reason, so the gate (``tests/test_torch_filolint.py``)
fails only on new findings: ``python tools/filolint_torch.py``.
"""

from filodb_tpu_torch.analysis.model import Baseline, Finding
from filodb_tpu_torch.analysis.runner import AnalysisContext, run_all

__all__ = ["AnalysisContext", "Baseline", "Finding", "run_all"]
