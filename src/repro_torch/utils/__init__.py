"""Utilities: analytic FLOP and byte accounting (``utils.flops``)."""
