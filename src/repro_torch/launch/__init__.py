"""Launchers: ``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train`` and ``python -m
repro_torch.launch.store`` (the served arena store); ``steps`` holds the
training step."""
