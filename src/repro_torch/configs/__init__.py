"""Model configurations: the ``ModelConfig`` dataclass (``configs.base``),
one data file per architecture (copies of the JAX package's, with their
``source`` citations) and the registry (``configs.registry``)."""
