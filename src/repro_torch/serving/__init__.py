"""Continuous-batching serving: the KV slot pool, the scheduler and the
engine."""
