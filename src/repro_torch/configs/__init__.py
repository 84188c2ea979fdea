"""Architecture configs (mirrors ``repro.configs``)."""
