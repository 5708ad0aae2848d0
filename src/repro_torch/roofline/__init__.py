"""Dry-run roofline: per-device counts of a step on meta DTensors, the
analytic byte floor, probe extrapolation, and the table of dry-run rows,
under the H100's constants (``python -m repro_torch.roofline``)."""
from repro_torch.roofline.analysis import (
    HW_H100,
    CostMode,
    RooflineReport,
    analyze_step,
    collective_bytes,
    model_flops_for,
)

__all__ = ["HW_H100", "CostMode", "RooflineReport", "analyze_step",
           "collective_bytes", "model_flops_for"]
