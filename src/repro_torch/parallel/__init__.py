"""Parallelism of the port: the Megatron logical-axis rules of
:mod:`repro_torch.parallel.sharding` mapped onto ``torch.distributed``
device meshes and DTensor placements."""
