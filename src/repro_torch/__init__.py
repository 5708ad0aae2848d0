"""PyTorch + CUDA port of the FRSZ2 CB-GMRES system, for NVIDIA Hopper.

A second package beside the JAX reference ``repro``: it imports neither JAX
nor ``repro``.  Entry points run on CUDA unless the caller asks for the CPU;
on the card the FRSZ2 basis is written, read, dotted and combined, the
operator applied, and an LM's FRSZ2-coded KV cache written and attended
over, by hand-written CUDA kernels (``kernels/csrc``), on the CPU by their
plain PyTorch versions.

  core     — FRSZ2 codec and the Accessor storage formats
  kernels  — Hopper kernels, their plain versions, the wrappers, the build
  sparse   — CSR/ELL operators and the synthetic problem suite
  solver   — restarted (CB-)GMRES (device and host drivers) and its
             pipeline stages
  dist     — the reduction context (local only so far)
  models   — the dense LM family's serving path and its KV cache
  configs  — the architecture registry
  launch   — ``python -m repro_torch.launch.solve`` and ``.serve``
  convert  — numpy hand-over of operators, stores, weights and KV caches
             to/from the JAX package
"""
