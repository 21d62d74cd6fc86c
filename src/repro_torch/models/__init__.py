"""The executable model in PyTorch: layers, the decoder-only LM (dense
and VLM families) and its API, plus the carry-over of a reference
parameter tree (:mod:`repro_torch.models.convert`)."""
