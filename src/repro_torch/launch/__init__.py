"""Launching the port: the production and debug device meshes and the
training launcher CLI (``python -m repro_torch.launch.train``)."""
