"""FrODO core, in PyTorch: graph, memory, optimizer (``core.frodo``),
baselines, consensus and the Algorithm-1 loop."""
