"""Measurement tools of the port: the structure probes (probe.py)."""
