"""PyTorch + CUDA port of the Latent-Parallelism video-diffusion server.

Same module layout as the JAX reference package ``repro`` (``repro/X.py``
has its port at ``repro_torch/X.py``), imports neither JAX nor ``repro``,
and runs on the GPU unless the caller passes ``device="cpu"``.  DiT
attention and the LP stitch run through hand-written CUDA kernels
(``repro_torch/kernels``).  ROADMAP.md lists what is ported.
"""
