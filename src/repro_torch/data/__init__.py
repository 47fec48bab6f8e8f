"""Synthetic data for the port's experiments."""
