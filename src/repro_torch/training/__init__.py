"""Training: losses, the agent-stacked FrODO step, the trainer and
checkpoints."""
