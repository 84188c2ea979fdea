"""Initialisers and layers (mirrors ``repro.nn``)."""
