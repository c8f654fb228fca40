"""Readers of the end-to-end metrics, one file a metric, found by name."""
