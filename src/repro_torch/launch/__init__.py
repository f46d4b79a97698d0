"""Launchers of the port: ``python -m repro_torch.launch.serve``, ``.train``
and ``.dryrun`` (every shape cell traced on fake tensors)."""
