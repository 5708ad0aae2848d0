"""Deterministic, host-sharded synthetic token pipeline."""
from repro_torch.data.pipeline import GlobalBatchSpec, synthetic_tokens

__all__ = ["GlobalBatchSpec", "synthetic_tokens"]
