"""Synthetic data and augmentation on the device (mirrors ``repro.data``)."""
