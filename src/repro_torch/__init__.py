"""repro_torch — the SplitPlace serving stack on PyTorch and CUDA.

A second package beside the JAX reference ``repro``, mirroring its layout
and names; it imports nothing of ``repro`` or ``jax``.
"""
