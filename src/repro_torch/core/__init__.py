"""Optimizer, loss and schedule math of the port (mirrors ``repro.core``)."""
