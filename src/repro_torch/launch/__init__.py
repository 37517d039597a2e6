"""Entry points of the port: ``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train`` and ``python -m
repro_torch.launch.dryrun`` (with ``launch.step_analysis``);
``launch.mesh`` builds device meshes."""
