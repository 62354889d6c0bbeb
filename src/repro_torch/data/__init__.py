"""Synthetic token sources."""
