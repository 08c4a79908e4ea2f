"""Device selection for the port's entry points.

Every entry point (``models.transformer.init_params``,
``serving.engine.ServingEngine``, ``launch.serve``) runs on the CUDA device
unless the caller passes ``device="cpu"``.  Without a GPU and without that
explicit request they raise: nothing falls back to the CPU quietly.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; a CUDA request without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run the port on the CPU")
    return dev
