"""Hand-written CUDA kernels of the port, for Hopper (``sm_90a``).

  flash_attention — DiT self- and cross-attention (``csrc/flash_attention.cu``)
  latent_blend    — LP's position-aware reconstruction (``csrc/latent_blend.cu``)

``ops.py`` holds the wrappers and launch counters, ``ref.py`` the plain
PyTorch versions (CPU tensors, and the yardstick on the card),
``build.py`` compiles the sources at first use.
"""
from . import ops, ref  # noqa: F401
