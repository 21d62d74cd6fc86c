"""The port's data pipeline: deterministic synthetic LM batches as numpy
arrays (the trainer moves them to its device)."""
