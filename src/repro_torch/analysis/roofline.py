"""Three-term roofline from dry-run artifacts (``repro.analysis.roofline``
counterpart), with the H100 as the default target.

    compute    = FLOPs / peak FLOP/s            (per device)
    memory     = bytes / HBM B/s                (per device)
    collective = wire_bytes_per_device / link B/s   (ring model)

An artifact says whether its FLOPs and bytes are per device
(``cost_is_per_device``, the reference's partitioned HLO) or for the
whole program (the port's traces), which is divided by the devices.

MODEL_FLOPS uses the 6*N*D rule (6*N_active*D for MoE) per training step
(3x forward for fwd+bwd; serving steps use 2*N*D per generated/processed
token).  The ratio MODEL_FLOPS / counted FLOPs exposes remat and
dispatch-einsum overheads.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["V5EConstants", "H100Constants", "RooflineTerms",
           "roofline_from_artifact", "model_flops"]


@dataclass(frozen=True)
class V5EConstants:
    """The reference's TPU v5e target, kept for parity checks only."""

    peak_flops: float = 197e12          # bf16 / chip
    hbm_bw: float = 819e9               # B/s / chip
    ici_bw: float = 5e10                # B/s / link
    hbm_per_chip: float = 16e9

    @property
    def link_bw(self) -> float:
        return self.ici_bw


@dataclass(frozen=True)
class H100Constants:
    """NVIDIA H100 SXM data-sheet numbers (dense, no sparsity).

    ``link_bw`` is one 400 Gb/s NDR InfiniBand port per GPU (50e9 B/s):
    every 16-wide group of the production meshes spans two nodes of 8
    GPUs, so a ring over it runs at the inter-node link, not at
    NVLink's 450e9 B/s a direction.
    """

    peak_flops: float = 989e12          # bf16 tensor cores
    hbm_bw: float = 3.35e12             # B/s, HBM3
    hbm_per_chip: float = 80e9
    link_bw: float = 50e9               # B/s, one NDR port


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops: float
    useful_ratio: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Optimistic (perfect overlap): max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time / bound step time."""
        if self.step_time_s <= 0:
            return 0.0
        ideal = (self.model_flops / max(self.hlo_flops, 1.0)) \
            * self.compute_s
        return ideal / self.step_time_s

    @property
    def roofline_fraction_cc(self) -> float:
        """Compute-vs-collective fraction (memory term excluded)."""
        bound = max(self.compute_s, self.collective_s)
        if bound <= 0:
            return 0.0
        return (self.model_flops / max(self.hlo_flops, 1.0)) \
            * self.compute_s / bound

    def to_dict(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops, "hlo_flops": self.hlo_flops,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(n_params_active: float, tokens: float, *,
                training: bool) -> float:
    """6*N*D (train: fwd+bwd) or 2*N*D (serve forward) per step."""
    return (6.0 if training else 2.0) * n_params_active * tokens


def roofline_from_artifact(art: dict, *,
                           hw: H100Constants | V5EConstants = H100Constants()
                           ) -> RooflineTerms:
    """``art`` is one dry-run JSON artifact (see launch/dryrun.py)."""
    cost = art["cost_analysis"]
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    per_device = art.get("cost_is_per_device", True)
    chips = art["n_devices"]
    if not per_device:
        flops /= chips
        nbytes /= chips
    coll = art["collectives"]
    wire = float(coll.get("total_wire_bytes_tpu",
                          coll["total_wire_bytes"]))
    mf = float(art["model_flops"]) / chips
    return RooflineTerms(
        compute_s=flops / hw.peak_flops,
        memory_s=nbytes / hw.hbm_bw,
        collective_s=wire / hw.link_bw,
        model_flops=mf,
        hlo_flops=max(flops, 1.0),
        useful_ratio=mf / max(flops, 1.0),
    )
