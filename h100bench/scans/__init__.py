"""Scan patterns, one a ``scan.kind`` name."""
