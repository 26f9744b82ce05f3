"""Layer-wise communication/computation profiler (paper §3, Fig. 4 "Profiler").

Framework-free copy of ``repro.core.profiler`` (the port imports nothing of
the JAX package).

DreamDDP's scheduler consumes per-layer backward times ``t_BP^l`` and
parameter-synchronization times ``t_COMM^l``.  :func:`analytic_profile`
derives them from per-layer FLOP/byte counts and a :class:`HardwareSpec`
roofline; the defaults are the reference's TPU v5e planning constants,
inputs of the planning model rather than measurements of the port.  The
JAX package's ``measured_profile`` (per-layer timing on the attached
backend) is not ported yet (ROADMAP.md queue A item 2).

It produces a :class:`LayerProfile`, the scheduler's only input — so the
schedule is *data*, recomputable when bandwidth changes (paper §6 limitation:
we expose :meth:`LayerProfile.with_bandwidth` for cheap re-profiling).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Sequence

__all__ = [
    "HardwareSpec",
    "LayerCost",
    "LayerProfile",
    "analytic_profile",
    "ring_allreduce_time",
    "V5E",
    "A6000_CLUSTER",
    "GEO_WAN",
]


@dataclass(frozen=True)
class HardwareSpec:
    """Roofline constants for one worker + the inter-worker link.

    ``bandwidth`` is the *per-link* bandwidth of the synchronization axis
    (bytes/s).  For geo-distributed pods this is the WAN link; for the paper's
    clusters it is 1 GB/s / 20 GB/s Ethernet.
    """

    name: str = "tpu-v5e"
    peak_flops: float = 197e12          # bf16 FLOP/s per chip
    hbm_bandwidth: float = 819e9        # bytes/s per chip
    ici_bandwidth: float = 5e10         # bytes/s per ICI link (intra-pod)
    bandwidth: float = 1e9              # bytes/s on the sync (slow/geo) axis
    latency: float = 5e-4               # per-collective latency on sync axis (s)
    n_workers: int = 32                 # workers on the sync axis
    chips_per_worker: int = 1           # 1 GPU (paper) or a whole pod (geo)
    mfu: float = 0.45                   # achievable fraction of peak for BP/FP
    bwd_fwd_ratio: float = 2.0          # t_BP ~= 2 x t_FP for matmul layers

    def replace(self, **kw) -> "HardwareSpec":
        return dataclasses.replace(self, **kw)


# Presets: the assigned TPU target, the paper's two clusters, and a geo WAN.
V5E = HardwareSpec()
A6000_CLUSTER = HardwareSpec(
    name="a6000x32", peak_flops=155e12, hbm_bandwidth=768e9,
    bandwidth=20e9, latency=3e-5, n_workers=32, mfu=0.40,
)
GEO_WAN = HardwareSpec(
    name="geo-wan", bandwidth=125e6, latency=5e-2, n_workers=4,
)


def ring_allreduce_time(nbytes: float, hw: HardwareSpec) -> float:
    """Ring all-reduce cost model: ``2 (K-1)/K * nbytes / bw + latency``.

    This is the standard bandwidth-optimal ring bound used throughout the
    paper's cost analysis (parameter averaging = all-reduce of params).
    """
    k = max(hw.n_workers, 2)
    return 2.0 * (k - 1) / k * nbytes / hw.bandwidth + hw.latency


@dataclass(frozen=True)
class LayerCost:
    """Profiled costs of one schedulable layer unit (network order)."""

    name: str
    flops_fwd: float = 0.0
    flops_bwd: float = 0.0
    param_bytes: float = 0.0
    t_fp: float = 0.0
    t_bp: float = 0.0
    t_comm: float = 0.0

    def scaled_comm(self, factor: float) -> "LayerCost":
        return dataclasses.replace(self, t_comm=self.t_comm * factor)


@dataclass
class LayerProfile:
    """Ordered per-layer costs, index 0 = input-most layer (network order).

    The scheduler reasons in *backward* order (output-most first); helpers
    here expose both views so callers never hand-flip indices.
    """

    layers: list[LayerCost]
    hw: HardwareSpec = field(default_factory=HardwareSpec)

    # ---- basic views -----------------------------------------------------
    def __len__(self) -> int:
        return len(self.layers)

    @property
    def t_fp_total(self) -> float:
        return sum(c.t_fp for c in self.layers)

    @property
    def t_bp_total(self) -> float:
        return sum(c.t_bp for c in self.layers)

    @property
    def t_comm_total(self) -> float:
        return sum(c.t_comm for c in self.layers)

    @property
    def total_param_bytes(self) -> float:
        return sum(c.param_bytes for c in self.layers)

    def bp_order(self) -> list[LayerCost]:
        """Layers in backward-pass order (output-most first)."""
        return list(reversed(self.layers))

    # ---- derived profiles ------------------------------------------------
    def with_bandwidth(self, bandwidth: float, latency: float | None = None,
                       n_workers: int | None = None) -> "LayerProfile":
        """Re-derive comm times for a new link (cheap re-profile, paper §6)."""
        hw = self.hw.replace(
            bandwidth=bandwidth,
            latency=self.hw.latency if latency is None else latency,
            n_workers=self.hw.n_workers if n_workers is None else n_workers,
        )
        layers = [
            dataclasses.replace(c, t_comm=ring_allreduce_time(c.param_bytes, hw))
            for c in self.layers
        ]
        return LayerProfile(layers, hw)

    def comm_compute_ratio(self) -> float:
        denom = self.t_fp_total + self.t_bp_total
        return self.t_comm_total / denom if denom else float("inf")

    # ---- (de)serialization -------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "hw": dataclasses.asdict(self.hw),
            "layers": [dataclasses.asdict(c) for c in self.layers],
        }, indent=1)

    @staticmethod
    def from_json(s: str) -> "LayerProfile":
        obj = json.loads(s)
        return LayerProfile(
            [LayerCost(**c) for c in obj["layers"]],
            HardwareSpec(**obj["hw"]),
        )


def analytic_profile(
    layer_params: Sequence[tuple[str, float, float]],
    hw: HardwareSpec,
    *,
    param_dtype_bytes: int = 2,
) -> LayerProfile:
    """Build a profile from ``(name, n_params, flops_fwd_per_step)`` triples.

    ``flops_fwd_per_step`` is the forward FLOPs of the layer for the *global*
    per-worker batch; backward is ``bwd_fwd_ratio`` x forward.  Communication
    is a ring all-reduce of the layer's parameter bytes over the sync axis.
    """
    layers = []
    for name, n_params, flops_fwd in layer_params:
        pbytes = n_params * param_dtype_bytes
        t_fp = flops_fwd / (hw.peak_flops * hw.mfu * hw.chips_per_worker)
        t_bp = t_fp * hw.bwd_fwd_ratio
        layers.append(LayerCost(
            name=name, flops_fwd=flops_fwd,
            flops_bwd=flops_fwd * hw.bwd_fwd_ratio,
            param_bytes=pbytes, t_fp=t_fp, t_bp=t_bp,
            t_comm=ring_allreduce_time(pbytes, hw),
        ))
    return LayerProfile(layers, hw)
