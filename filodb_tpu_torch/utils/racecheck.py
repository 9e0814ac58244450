"""The race sanitizer's registration calls, as a stand-in.

``filodb_tpu/utils/racecheck.py`` is a runtime lockset checker: objects
and dicts registered with it record which locks guarded each write, and
a test session fails on a write no common lock guards. The rules manager
registers its group state with it (``rules/manager.py``). The checker
itself comes with the port's tooling (ROADMAP §A.13); until then
``register`` returns its argument and ``tracked_dict`` a plain dict, so a
caller registers as the reference does and nothing is tracked.
"""

from __future__ import annotations


def tracked_dict(label: str, initial=None) -> dict:
    """A plain dict of ``initial``, untracked."""
    return dict(initial or {})


def register(obj, label: str):
    """``obj``, untracked."""
    return obj
