"""The paper's experiments and the kernel bench as entry points of the
port (``python -m repro_torch.experiments.<name>``)."""
