"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version. CUDA sources live under ``csrc/`` and are compiled
with ``nvcc`` at first use (see :mod:`repro_torch.kernels.build`)."""
