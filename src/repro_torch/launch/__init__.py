"""Entry points (``python -m repro_torch.launch.train``,
``python -m repro_torch.launch.serve``)."""
