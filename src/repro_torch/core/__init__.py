"""The paper's contribution: FRSZ2 block compression + the Accessor contract.

  frsz2      — dtype-generic block floating-point codec (paper Sec. IV)
  accessor   — storage format ⊥ arithmetic format (Ginkgo Accessor)
"""
from repro_torch.core.frsz2 import (
    FRSZ2_8,
    FRSZ2_16,
    FRSZ2_21,
    FRSZ2_32,
    BlockCompressed,
    FrszSpec,
    bits_per_value,
    compress,
    decompress,
    storage_nbytes,
)
from repro_torch.core.accessor import (
    BasisAccessor,
    BlockBasisAccessor,
    FrszFormat,
    MixedFormat,
    NativeFormat,
    StorageFormat,
    format_by_name,
    register_format,
)
