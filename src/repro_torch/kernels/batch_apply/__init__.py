"""Batch-apply group-resolve kernel K4."""
