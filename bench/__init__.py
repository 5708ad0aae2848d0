"""The benchmark of the PyTorch port (``repro_torch``): see ``run.py``."""
