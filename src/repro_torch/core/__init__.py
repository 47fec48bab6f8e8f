"""FrODO core, in PyTorch: graph, memory, optimizer (``core.frodo``),
baselines, consensus and the Algorithm-1 loop.  The flat import surface
follows the JAX package's ``repro.core``."""
# graph and memory first: ``kernels.ref``, which ``core.frodo`` reaches,
# imports ``core.memory``
from repro_torch.core import graph, memory
from repro_torch.core.frodo import FrodoConfig, Optimizer, apply_updates, frodo
from repro_torch.core.baselines import (REGISTRY as OPTIMIZERS, adam,
                                        heavy_ball, nesterov, no_memory)
from repro_torch.core.faults import (FAULT_COUNTER_NAMES, CompiledFaults,
                                     CrashWindow, FaultSchedule)
from repro_torch.core import consensus, faults, loop, theory

__all__ = ["CompiledFaults", "CrashWindow", "FAULT_COUNTER_NAMES",
           "FaultSchedule", "FrodoConfig", "Optimizer", "frodo",
           "apply_updates", "no_memory", "heavy_ball", "nesterov", "adam",
           "OPTIMIZERS", "memory", "graph", "consensus", "faults", "theory",
           "loop"]
