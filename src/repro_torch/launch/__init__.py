"""Measurement tools of the port (mirrors ``repro.launch``)."""
