"""PyTorch + CUDA port of ``repro`` for NVIDIA Hopper (H100, sm_90a).

The JAX package ``repro`` is the reference; this package mirrors it
module by module and imports nothing of it.  Slice 1 covers the serving
main path of the dense GQA decoder (``granite-8b``): model, paged and
dense KV caches, the continuous-batching engine, and four hand-written
CUDA kernels (``csrc/``) that replace the Pallas kernels on that path.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper takes its plain
PyTorch version, which is what the tests compare against ``repro``.
"""
