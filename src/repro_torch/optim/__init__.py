"""Optimizers of the live trainer."""
