"""repro_torch — the PyTorch/CUDA port of the DistSim reproduction.

A package of its own beside the JAX reference package ``repro``: it
imports ``torch`` and ``numpy`` and nothing of the reference. Layout and
names mirror the reference (``repro_torch/core/megabatch.py`` is the
counterpart of ``repro/core/megabatch.py``), so a reader finds a
module's twin by path. Entry points run on the card unless the caller
passes ``device="cpu"``; hand-written CUDA kernels live under
``repro_torch/kernels/csrc`` and are compiled at first use.

Ported so far: the strategy-serving path — configs, events, providers,
the event-flow engine, the mega-batch program with its Hopper scan
kernel, the profile store and ``DistSim.serve()`` — and the model's
serving path — the dense/VLM LM with its prefill and decode steps, the
Hopper flash-attention and RMSNorm kernels and their ``ops`` wrappers.
"""
