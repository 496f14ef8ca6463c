"""Convergence engine, drivers and results (``repro.experiments``)."""
