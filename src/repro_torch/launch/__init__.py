"""Entry points of the live two-tier trainer."""
