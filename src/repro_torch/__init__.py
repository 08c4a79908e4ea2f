"""PyTorch + CUDA port of the ``repro`` serving system for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
subpackage and file names so every module names its counterpart.  It
imports ``torch`` and numpy only: nothing of ``jax`` and nothing of
``repro``.  Entry points run on the CUDA device unless the caller asks
for ``device="cpu"`` (``device.resolve_device``).
"""
