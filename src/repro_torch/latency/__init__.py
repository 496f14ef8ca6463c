"""Latency model (numpy; copied from ``repro.latency``)."""
