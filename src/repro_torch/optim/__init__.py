"""AdamW, with its moments optionally FRSZ2-coded (kernels 1 and 2)."""
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, lr_at

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "lr_at"]
