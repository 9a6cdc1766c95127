"""Measurement tools of the port (counterparts of ``tools/`` probes)."""
