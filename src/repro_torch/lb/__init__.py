"""Partition arithmetic (copied from ``repro.lb``)."""
