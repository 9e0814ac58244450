#!/usr/bin/env python3
"""Run filolint (static concurrency/invariant analysis) over the port.

The port's own copy of the analyser (``filodb_tpu_torch/analysis``),
aimed at ``filodb_tpu_torch/`` and gated by
``conf/filolint_torch_baseline.json``; it runs from a checkout without
installation:

    python tools/filolint_torch.py                 # gate against the baseline
    python tools/filolint_torch.py --no-baseline   # show everything
    python tools/filolint_torch.py --update-baseline

Installed entry point: ``filolint-torch`` (see pyproject.toml).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from filodb_tpu_torch.analysis.cli import main  # noqa: E402

if __name__ == "__main__":
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = sys.argv[1:]
    if not any(a.startswith("--root") for a in argv):
        argv = ["--root", repo] + argv
    sys.exit(main(argv))
