"""Mixture-of-Experts feed-forward (token-choice top-k, capacity-based).

Counterpart of ``repro.models.moe``, in plain functions on tensors.  The
reference's dense dispatch is kept as it is: dispatch and combine are
one-hot einsums ``[b, s, e, c]``, and every expert computes on all ``c``
capacity slots of every sequence, whether a token was routed there or
not (an empty slot computes on zeros).  At decode (``s = 1``) the
capacity is ``top_k``, so a tick reads every expert's weights.

Capacity is per sequence, ``c = max(int(s * k / e * capacity_factor),
k)`` (the MaxText/Switch convention), taken from the length the layer
sees: a right-padded prefill bucket counts its pad.  Slots are given in
position-major order (sequence position first, routing rank second), so
a pad at the end never displaces a real token; overflow tokens are
dropped with combine weight 0.

Routing variants: ``router="softmax"`` (softmax over every expert,
renormalised top-k; Qwen3-MoE) and ``router="sigmoid"`` (sigmoid
scores, top-k, renormalised, times ``routed_scale``; DeepSeek-V3's
routing without the bias update), plus ``n_shared`` always-on shared
experts.

One-hots are built by comparing with an ``arange``: a dropped token's
out-of-range slot index ``c`` then gives a zero row, as
``jax.nn.one_hot`` does (``torch.nn.functional.one_hot`` raises on it),
with no host check, so the layer runs inside a CUDA graph capture.

**The held, dropless layer** (:class:`HeldMoEConfig`; the port's own,
the reference has none).  ``experts_held=(first, count)`` says which of
the ``n_experts`` this chip holds (all of them by default), as one share
of expert parallelism: the router keeps its full width and routes every
token over all of them; the (token, choice) pairs whose expert is held
are put in order of expert by a stable sort into a static buffer of
``T * k`` rows, with each expert's offsets kept on the device; gate and up
run as one grouped product (``N = 2 d_ff``), then SiLU times up and the
down product (:func:`~repro_torch.kernels.grouped_gemm.grouped_mm`);
each token then sums its rows times their routing weights.  Nothing is
dropped, whatever the load.  A pair routed to an expert held elsewhere
adds nothing here: its row lies past the last group and the products
write zeros there.  The shared experts are added whole.  Every step runs
on the device with no host read, so the layer runs inside a CUDA graph
capture, and every sum is taken in a fixed order (the permute's backward
sums each token's ``k`` rows by gather), so a replay is bitwise the
eager pass.  Spans ``repro_torch.moe.{route,permute,experts,combine}``
name its parts; a :class:`RoutedRows` given to :func:`moe_apply` counts
the rows each held expert took.  DeepSeek-V3's ``noaux_tc`` selection
bias is zero until a bias update moves it, and no update runs here, so
it is left out; with one group, group-limited routing selects among all
experts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from ..kernels.grouped_gemm import grouped_mm
from ..spans import span
from .layers import dense, normal

__all__ = ["MoEConfig", "HeldMoEConfig", "RoutedRows", "moe_init",
           "moe_specs", "moe_apply", "moe_param_count",
           "moe_active_param_count", "moe_fwd_flops"]

Tree = Any


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden size
    n_shared: int = 0            # always-on shared experts
    capacity_factor: float = 1.25
    router: str = "softmax"      # or "sigmoid"
    routed_scale: float = 1.0    # DeepSeek routed_scaling_factor (2.5 for V3)

    @property
    def dropless(self) -> bool:
        """The held, dropless layer (:class:`HeldMoEConfig`) or not."""
        return False

    @property
    def held(self) -> tuple[int, int]:
        """(first, count) of the experts whose weights this layer holds."""
        return (0, self.n_experts)

    def capacity(self, seq_len: int) -> int:
        c = int(seq_len * self.top_k / self.n_experts * self.capacity_factor)
        return max(c, self.top_k)


@dataclass(frozen=True)
class HeldMoEConfig(MoEConfig):
    """The dropless layer, holding every expert or one share of expert
    parallelism: ``experts_held=(first, count)`` of the ``n_experts``
    the router chooses among.  It has no capacity; a subclass, so that
    :class:`MoEConfig`'s fields stay the reference's."""

    experts_held: tuple[int, int] | None = None

    def __post_init__(self):
        if self.experts_held is not None:
            first, count = self.experts_held
            if not (0 <= first and 0 < count
                    and first + count <= self.n_experts):
                raise ValueError(f"experts_held {self.experts_held} is not "
                                 f"a range of {self.n_experts} experts")

    @property
    def dropless(self) -> bool:
        return True

    @property
    def held(self) -> tuple[int, int]:
        return self.experts_held or (0, self.n_experts)

    def capacity(self, seq_len: int) -> int:
        raise ValueError("the held expert layer is dropless: no capacity")


def moe_init(gen: torch.Generator, cfg: MoEConfig, d_model: int, *,
             dtype=torch.bfloat16, stack: tuple = ()) -> Tree:
    """Router ``[*stack, d, e]`` (float32), stacked expert SwiGLU weights
    ``gate``/``up`` ``[*stack, e, d, f]`` and ``down`` ``[*stack, e, f,
    d]``, and the shared experts, at the reference's scales.  A held
    layer stacks only its held experts (``[*stack, count, ...]``); its
    router keeps all ``e`` outputs."""
    e, f = cfg.n_experts, cfg.d_ff
    held = cfg.held[1]
    s_in, s_out = d_model ** -0.5, f ** -0.5
    p = {
        "router": {"w": normal(gen, (*stack, d_model, e), s_in,
                               torch.float32)},
        "gate": normal(gen, (*stack, held, d_model, f), s_in, dtype),
        "up": normal(gen, (*stack, held, d_model, f), s_in, dtype),
        "down": normal(gen, (*stack, held, f, d_model), s_out, dtype),
    }
    if cfg.n_shared:
        fs = f * cfg.n_shared
        p["shared"] = {
            "gate": {"w": normal(gen, (*stack, d_model, fs), s_in, dtype)},
            "up": {"w": normal(gen, (*stack, d_model, fs), s_in, dtype)},
            "down": {"w": normal(gen, (*stack, fs, d_model), s_out, dtype)},
        }
    return p


def moe_specs(cfg: MoEConfig) -> Tree:
    """Logical axes of :func:`moe_init`'s leaves (one unstacked layer):
    experts over ``expert``, their hidden dim ``ff``."""
    spec = {"router": {"w": (None, None)},
            "gate": ("expert", None, "ff"),
            "up": ("expert", None, "ff"),
            "down": ("expert", "ff", None)}
    if cfg.n_shared:
        spec["shared"] = {"gate": {"w": (None, "ff")},
                          "up": {"w": (None, "ff")},
                          "down": {"w": ("ff", None)}}
    return spec


def _route(cfg: MoEConfig, logits: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing -> (weights ``[b, s, k]`` float32, indices)."""
    if cfg.router == "softmax":
        scores = torch.softmax(logits, dim=-1)
    elif cfg.router == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        raise ValueError(cfg.router)
    # jax.lax.top_k's order: the lower index first on ties (a stable
    # descending sort; torch.topk promises no order among equal scores)
    w, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    w, idx = w[..., :cfg.top_k], idx[..., :cfg.top_k]
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    if cfg.router == "sigmoid":
        w = w * cfg.routed_scale
    return w, idx


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside ``[0, n)`` gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


class RoutedRows:
    """Rows each held expert took, counted on the device: ``total
    [layers, held]`` int64 sums every counted call, ``peak [layers,
    held]`` keeps the most one call gave (one worker's step).  Both are
    made at the first count and then updated in place, so a captured
    graph adds to them on every replay; read them after the device has
    finished.  A call counts only once its layer was armed
    (:meth:`arm`), and counting disarms it: the forward that a
    checkpointed block recomputes in the backward pass is not counted
    again."""

    def __init__(self, n_layers: int, held: int):
        self.shape = (n_layers, held)
        self.total: torch.Tensor | None = None
        self.peak: torch.Tensor | None = None
        self._armed: set[int] = set()

    def arm(self, layer: int) -> None:
        self._armed.add(layer)

    def add(self, layer: int, counts: torch.Tensor) -> None:
        if layer not in self._armed:
            return
        self._armed.discard(layer)
        if self.total is None or self.total.device != counts.device:
            self.total = torch.zeros(self.shape, dtype=torch.int64,
                                     device=counts.device)
            self.peak = torch.zeros_like(self.total)
        self.total[layer] += counts
        torch.maximum(self.peak[layer], counts, out=self.peak[layer])

    def reset(self) -> None:
        """Zero both counters in place (the graphs keep their tensors)."""
        if self.total is not None:
            self.total.zero_()
            self.peak.zero_()


class _GatherRows(torch.autograd.Function):
    """``x[order // k]``: each token's row once for each of its ``k``
    pairs, in the permuted order; the backward sums a token's ``k`` rows
    by gather (``inv``, the inverse permutation), in a fixed order."""

    @staticmethod
    def forward(ctx, x, order, inv, k):
        ctx.save_for_backward(inv)
        ctx.k = k
        return x[order // k]

    @staticmethod
    def backward(ctx, grad):
        (inv,) = ctx.saved_tensors
        t = inv.shape[0] // ctx.k
        return grad[inv].reshape(t, ctx.k, -1).sum(1), None, None, None


class _Unpermute(torch.autograd.Function):
    """``y[inv]``: the permuted rows back in (token, choice) order; the
    backward is the gather ``grad[order]`` (a permutation: no sums)."""

    @staticmethod
    def forward(ctx, y, inv, order):
        ctx.save_for_backward(order)
        return y[inv]

    @staticmethod
    def backward(ctx, grad):
        (order,) = ctx.saved_tensors
        return grad[order], None, None


def _moe_held(p: Tree, cfg: MoEConfig, x: torch.Tensor,
              rows: RoutedRows | None, layer: int) -> torch.Tensor:
    """The dropless layer over the held experts (module docstring)."""
    b, s, d = x.shape
    t, k = b * s, cfg.top_k
    first, held = cfg.held
    xt = x.reshape(t, d)
    with span("repro_torch.moe.route"):
        weights, idx = _route(cfg, xt.float() @ p["router"]["w"])  # [t,k]
    with span("repro_torch.moe.permute"):
        local = (idx - first).reshape(-1)
        key = torch.where((local >= 0) & (local < held), local,
                          torch.full_like(local, held))
        order = torch.sort(key, stable=True).indices             # [t k]
        counts = torch.zeros(held + 1, dtype=torch.int64,
                             device=x.device).index_add_(
            0, key, torch.ones_like(key))[:held]
        offs = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(
            torch.int32)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(t * k, device=x.device)
        xs = _GatherRows.apply(xt, order, inv, k)               # [t k, d]
        if rows is not None:
            rows.add(layer, counts)
    with span("repro_torch.moe.experts"):
        gu = grouped_mm(xs, torch.cat([p["gate"], p["up"]], dim=-1), offs)
        g, u = gu.split(cfg.d_ff, dim=-1)
        ys = grouped_mm(F.silu(g) * u, p["down"], offs)         # [t k, d]
    with span("repro_torch.moe.combine"):
        yk = _Unpermute.apply(ys, inv, order).reshape(t, k, d)
        out = (yk.float() * weights[..., None]).sum(1).to(x.dtype)
    return out.reshape(b, s, d)


def _shared(p: Tree, x: torch.Tensor) -> torch.Tensor:
    sh = p["shared"]
    hs = F.silu(dense(sh["gate"], x)) * dense(sh["up"], x)
    return dense(sh["down"], hs)


def moe_apply(p: Tree, cfg: MoEConfig, x: torch.Tensor, *,
              rows: RoutedRows | None = None, layer: int = 0
              ) -> torch.Tensor:
    """x ``[b, s, d]`` -> ``[b, s, d]``: top-k routed + shared experts.
    The dropless layer counts its rows into ``rows`` at index ``layer``
    when that layer is armed."""
    if cfg.dropless:
        out = _moe_held(p, cfg, x, rows, layer)
        return out + _shared(p, x) if cfg.n_shared else out
    b, s, d = x.shape
    e, k, c = cfg.n_experts, cfg.top_k, cfg.capacity(s)

    logits = x.float() @ p["router"]["w"]                     # [b,s,e]
    weights, idx = _route(cfg, logits)                        # [b,s,k]

    # --- capacity assignment (Switch-style, per sequence) -----------------
    onehot = _one_hot(idx, e, torch.int32)                    # [b,s,k,e]
    # priority: sequence position major, then routing rank
    pos = onehot.reshape(b, s * k, e).cumsum(1) - 1           # [b,s*k,e]
    pos_of = (pos.reshape(b, s, k, e) * onehot).sum(-1)       # [b,s,k]
    keep = pos_of < c
    w_kept = weights * keep                                   # dropped -> 0

    # dispatch / combine [b,s,e,c], both in the activation dtype
    slot = _one_hot(torch.where(keep, pos_of, c), c, x.dtype)  # [b,s,k,c]
    hot = onehot.to(x.dtype)
    disp = torch.einsum("bske,bskc->bsec", hot * keep[..., None], slot)
    comb = torch.einsum("bske,bskc->bsec",
                        hot * w_kept[..., None].to(x.dtype), slot)

    # --- expert compute: every expert on its c slots -----------------------
    xe = torch.einsum("bsec,bsd->ebcd", disp, x)              # [e,b,c,d]
    h = F.silu(torch.einsum("ebcd,edf->ebcf", xe, p["gate"])) \
        * torch.einsum("ebcd,edf->ebcf", xe, p["up"])
    ye = torch.einsum("ebcf,efd->ebcd", h, p["down"])         # [e,b,c,d]
    out = torch.einsum("bsec,ebcd->bsd", comb, ye)

    if cfg.n_shared:
        out = out + _shared(p, x)
    return out


# ---------------------------------------------------------------------------
# Analytic accounting (profiler / roofline), the reference's formulas
# ---------------------------------------------------------------------------

def moe_param_count(cfg: MoEConfig, d_model: int) -> int:
    """The layer's parameters on this chip: the router, the held experts
    (all of them but in a held layer), the shared experts."""
    n = d_model * cfg.n_experts                      # router
    n += 3 * cfg.held[1] * d_model * cfg.d_ff        # routed experts
    n += 3 * cfg.n_shared * d_model * cfg.d_ff       # shared
    return n


def _routed_per_token(cfg: MoEConfig) -> float:
    """Experts a token runs here: ``top_k``, or in a held layer the
    expected share ``top_k * held / n_experts``."""
    return cfg.top_k * cfg.held[1] / cfg.n_experts


def moe_active_param_count(cfg: MoEConfig, d_model: int) -> int:
    """Per-token active parameters (for MODEL_FLOPS = 6*N_active*D); a
    held layer counts the expected share of its routed rows."""
    n = d_model * cfg.n_experts
    n += round(3 * _routed_per_token(cfg) * d_model * cfg.d_ff)
    n += 3 * cfg.n_shared * d_model * cfg.d_ff
    return n


def moe_fwd_flops(cfg: MoEConfig, d_model: int, tokens: int,
                  seq_len: int) -> float:
    """Forward FLOPs actually executed (dispatch and combine included);
    the dropless layer's are its active ones: the router, the expected
    routed rows of its held experts (``tokens * top_k * held /
    n_experts``) and the shared experts."""
    e = cfg.n_experts
    if cfg.dropless:
        flops = 2.0 * tokens * d_model * e                   # router
        flops += 2.0 * tokens * _routed_per_token(cfg) * d_model \
            * cfg.d_ff * 3                                   # routed rows
        flops += 2.0 * tokens * d_model * (cfg.n_shared * cfg.d_ff) * 3
        return flops
    c = cfg.capacity(seq_len)
    flops = 2.0 * tokens * d_model * e                       # router
    flops += 2.0 * tokens * e * c * d_model * 2              # dispatch+combine
    eff = tokens / seq_len * e * c                           # slot-tokens
    flops += 2.0 * eff * d_model * cfg.d_ff * 3              # expert SwiGLU
    flops += 2.0 * tokens * d_model * (cfg.n_shared * cfg.d_ff) * 3
    return flops
