"""Synthetic data and length samplers (numpy)."""
