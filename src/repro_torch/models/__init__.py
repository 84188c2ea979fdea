"""Models (mirrors ``repro.models``)."""
