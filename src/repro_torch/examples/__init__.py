"""The reference's examples on the port's modules, each run as
``python -m repro_torch.examples.<name>`` with ``--device`` (the card
by default; ``cpu`` only when asked)."""
