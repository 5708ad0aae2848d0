"""Hopper kernels for the FRSZ2 hot paths, with their plain versions.

Modules:
  frsz2_kernel  - compress / decompress (csrc/frsz2_codec.cu)
  frsz2_dot     - fused decode + matvec / rmatvec (csrc/frsz2_dot.cu)
  ell_spmv      - ELL SpMV, dense or FRSZ2-coded operand (csrc/ell_spmv.cu)
  gmres_step    - the device cycle's Givens step (csrc/gmres_step.cu)
  decode_attn   - flash-decode attention over an FRSZ2-coded KV cache
                  (csrc/decode_attn.cu)
  ops           - public wrappers (routing, validation, launch counts)
  ref           - plain PyTorch versions of all of the above
  build         - nvcc build of csrc/ and ctypes loading
"""
