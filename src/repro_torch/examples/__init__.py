"""Runnable examples of the port: ``python -m repro_torch.examples.<name>``.

  train_lm      — a ~100M-parameter yi-topology model trained with
                  checkpoint and restart, optionally FRSZ2-coded Adam state
  serve_decode  — batched serving over exact, bf16 and FRSZ2 KV caches
"""
