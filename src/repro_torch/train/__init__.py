"""Train state and trainer (mirrors ``repro.train``)."""
