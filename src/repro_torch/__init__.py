"""PyTorch/CUDA port of the FrODO package (``repro``), for NVIDIA Hopper.

The layout mirrors ``src/repro/`` module for module.  The port imports
``torch``, ``numpy`` and ``scipy`` only; it never imports ``jax`` or the JAX
package.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (``repro_torch.device.resolve_device``).
"""
