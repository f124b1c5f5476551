"""Synthetic data for the trainer (the counterpart of ``repro.data``)."""
