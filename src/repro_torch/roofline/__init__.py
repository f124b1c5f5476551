"""Roofline accounting on the H100's peaks (``analysis``) and the
analytic per-cell model (``model``)."""
