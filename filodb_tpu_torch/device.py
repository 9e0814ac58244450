"""Device and dtype policy of the port (twin of
``filodb_tpu/query/engine/kernels.py::fdtype``).

Entry points take ``device=`` and default to the CUDA card. Without CUDA
they raise unless the caller asked for the CPU explicitly, where every
kernel wrapper runs its plain PyTorch version. Nothing silently carries on
on the CPU.

Dtypes: device pages store float32 values, and the hand-written kernels
compute in float32, as the TPU kernels do. A batch whose values float32
does not hold takes the host-decode lane, float64 values decoded from the
codec chunks (``query/engine/batch.py``); the precision gate
(``query/exec/transformers.py``) sends a batch of exact values whose
magnitudes float32 cannot difference exactly through the plain path in
float64 on the same device.
"""

from __future__ import annotations

import torch

KERNEL_DTYPE = torch.float32
EXACT_DTYPE = torch.float64


def resolve(device: "str | torch.device | None" = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: filodb_tpu_torch runs on the GPU by "
            "default; pass device='cpu' to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
