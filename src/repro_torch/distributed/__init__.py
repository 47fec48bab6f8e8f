"""The distributed layer: logical-axis sharding rules and spec trees
(``sharding``) and the collectives on ``torch.distributed`` that the
consensus forms and the agent-sharded train step use (``comm``).  Meshes
are built in ``repro_torch.launch.mesh``."""
