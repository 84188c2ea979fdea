"""Small cross-layer utilities (mirrors ``repro.utils``)."""
