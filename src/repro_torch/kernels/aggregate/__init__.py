"""Aggregation group-resolve kernel K3."""
