"""Serving (mirrors ``repro.serve``)."""
