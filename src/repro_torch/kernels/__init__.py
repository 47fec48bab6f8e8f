"""Fused FrODO update: hand-written CUDA kernels and their plain versions."""
