"""Hopper kernels for the FRSZ2 hot paths, with their plain versions.

Modules:
  frsz2_kernel  - compress / decompress (csrc/frsz2_codec.cu)
  frsz2_dot     - fused decode + matvec / rmatvec (csrc/frsz2_dot.cu)
  ops           - public wrappers (routing, validation, launch counts)
  ref           - plain PyTorch versions of all of the above
  build         - nvcc build of csrc/ and ctypes loading
"""
