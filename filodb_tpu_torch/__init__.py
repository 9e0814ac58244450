"""filodb_tpu_torch: the PyTorch/CUDA port of filodb_tpu (see README,
"PyTorch/CUDA port"). Imports neither JAX nor any ``filodb_tpu`` module.

``FILODB_LOCKCHECK=1`` arms the runtime lock-order checker and
``FILODB_RACECHECK=1`` the shared-state race sanitizer for the whole
process, here at the package's import, before any of its modules creates
a lock or registers shared state (``utils/lockcheck.py``,
``utils/racecheck.py``); ``FILODB_LOCKCHECK_STRICT=1`` /
``FILODB_RACECHECK_STRICT=1`` make a violation raise where it happens.
"""

import os


def _flag(name: str) -> bool:
    return os.environ.get(name, "") not in ("", "0", "false")


if _flag("FILODB_LOCKCHECK"):
    from filodb_tpu_torch.utils import lockcheck as _lockcheck

    _lockcheck.install(strict=_flag("FILODB_LOCKCHECK_STRICT"))
if _flag("FILODB_RACECHECK"):
    # after lockcheck: the guard sets come from its held-lock stack
    from filodb_tpu_torch.utils import racecheck as _racecheck

    _racecheck.install(strict=_flag("FILODB_RACECHECK_STRICT"))
