"""The paper's experiments as entry points of the port
(``python -m repro_torch.experiments.<name>``)."""
