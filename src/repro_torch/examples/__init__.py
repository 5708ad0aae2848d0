"""Runnable examples of the port: ``python -m repro_torch.examples.<name>``.

  quickstart    — the FRSZ2 codec and CB-GMRES on ``synth:atmosmod`` for
                  float64, float32 and frsz2_32 (the JAX package's
                  ``examples/quickstart.py``, line for line)
  solve_cfd     — the cycle pipeline: Jacobi preconditioning and the
                  adaptive precision policy (``pipeline_demo``)
  train_lm      — a ~100M-parameter yi-topology model trained with
                  checkpoint and restart, optionally FRSZ2-coded Adam state
  serve_decode  — batched serving over exact, bf16 and FRSZ2 KV caches
"""
