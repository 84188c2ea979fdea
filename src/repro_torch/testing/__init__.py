"""Deterministic fault injection for chaos testing (mirrors ``repro.testing``)."""

from repro_torch.testing.chaos import FaultPlan, TransientDataError  # noqa: F401
