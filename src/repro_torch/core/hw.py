"""Target hardware models: the chips a simulated cluster is built from.

Every analytical event time derives from a :class:`ChipSpec`. These
describe SIMULATED TARGETS, not the machine the simulator runs on:

* ``V5E`` — a TPU v5e chip (197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s
  per ICI link), kept field for field as the reference package has it
  so stores and predictions for that target stay interchangeable.
* ``H100`` — an NVIDIA H100 SXM5, the port's default target. Datasheet
  values (NVIDIA H100 data sheet / Hopper white paper), not
  measurements; ``op_overhead`` and the efficiency curve are modelling
  assumptions to be calibrated against a measured provider.

The field names are the reference's (``vmem_bytes``, ``ici_*``,
``dcn_*``, ``mxu_dim``) because ``ClusterSpec.to_dict()`` feeds the
profile-store namespace; for a GPU they read as on-chip fast memory,
the island-internal link, the cross-island link and the matrix-unit
tile side.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str = "tpu-v5e"
    peak_flops_bf16: float = 197e12          # FLOP/s per chip
    hbm_bw: float = 819e9                    # bytes/s
    hbm_bytes: float = 16e9                  # HBM capacity per chip
    vmem_bytes: float = 128 * 2 ** 20        # ~128 MiB VMEM
    ici_link_bw: float = 50e9                # bytes/s per ICI link (one dir)
    ici_links_per_axis: int = 2              # bidirectional ring → 2 links
    dcn_bw: float = 25e9                     # bytes/s per host inter-pod (DCN)
    mxu_dim: int = 128                       # systolic array side
    # launch/fusion fixed overhead per HLO op (s). Calibratable.
    op_overhead: float = 2e-6
    # collective latency term per hop (s)
    ici_hop_latency: float = 1e-6
    dcn_latency: float = 25e-6


V5E = ChipSpec()


def mxu_efficiency(m: int, n: int, k: int, spec: ChipSpec = V5E) -> float:
    """Fraction of peak a GEMM of logical dims (m,n,k) achieves.

    TPU systolic arrays lose throughput when dims are not multiples of the
    MXU tile and when the surface-to-volume ratio is bad (small dims).
    This simple two-factor model is the analytical provider's efficiency
    curve; MeasuredProvider replaces it with real timings.
    """
    d = spec.mxu_dim

    def align(x: int) -> float:
        if x >= d:
            full = (x // d) * d
            return max(full / x, 0.75)        # ragged tail wastes a tile
        return max(x / d, 0.05)               # under-filled systolic array

    a = align(m) * align(n) * align(k)
    # small-matrix pipeline fill/drain penalty
    depth = min(m, n, k)
    fill = depth / (depth + d)
    return max(0.04, min(0.95, a * (0.5 + 0.5 * fill) * 0.85))


#: NVIDIA H100 SXM5 — datasheet values. Fast memory is the 50 MB L2; the
#: island link is NVLink4 (450 GB/s per direction, all-to-all through
#: NVSwitch, so one "ring link" per axis at the full rate); the
#: cross-island link is one 400 Gb/s NIC per GPU. ``op_overhead`` is an
#: assumed eager-mode kernel launch cost, not a datasheet number.
H100 = ChipSpec(
    name="h100-sxm5",
    peak_flops_bf16=989e12,
    hbm_bw=3.35e12,
    hbm_bytes=80e9,
    vmem_bytes=50e6,
    ici_link_bw=450e9,
    ici_links_per_axis=1,
    dcn_bw=50e9,
    mxu_dim=64,
    op_overhead=4e-6,
    ici_hop_latency=2e-6,
    dcn_latency=10e-6,
)

#: streaming multiprocessors of an H100 SXM5 (wave quantization below)
H100_SMS = 132


def tensor_core_efficiency(m: int, n: int, k: int, spec: ChipSpec = H100,
                           n_sms: int = H100_SMS) -> float:
    """Fraction of the dense bf16 peak a GEMM (m,n,k) achieves on Hopper.

    The counterpart of :func:`mxu_efficiency` for a GPU target, where
    the losses have other causes than a 128-wide systolic array:

    * **tile quantization** — a thread block computes a 128x128 output
      tile from ``wgmma`` operations of ``mxu_dim`` (64) rows and a
      k-depth of 64 bf16 values per pipeline stage; ragged edges pad up;
    * **wave quantization** — tiles are dealt to ``n_sms`` SMs in
      waves, and a partial last wave leaves SMs idle;
    * **pipeline fill** — short k loops never reach the steady state of
      the load/compute ring.

    An analytical curve (assumption, not a measurement); a measured
    provider replaces it with timings.
    """
    tile_m = 128 if m > spec.mxu_dim else spec.mxu_dim
    tile_n, tile_k = 128, 64

    def ceil_div(a: int, b: int) -> int:
        return -(-a // b)

    tm, tn, tk = ceil_div(m, tile_m), ceil_div(n, tile_n), ceil_div(k, tile_k)
    quant = (m * n * k) / float(tm * tile_m * tn * tile_n * tk * tile_k)
    tiles = tm * tn
    wave = tiles / float(ceil_div(tiles, n_sms) * n_sms)
    fill = k / (k + 4.0 * tile_k)
    return max(0.02, min(0.80, 0.80 * quant * wave * fill))
