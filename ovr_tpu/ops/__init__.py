"""The fused slice-loop kernel (Pallas) and the bounded-memory adjoints."""

from ovr_tpu.ops.adjoint import over_scan

__all__ = ["over_scan"]
