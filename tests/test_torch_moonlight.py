"""Moonlight-16B-A3B in the port: MLA without query LoRA, the dropless
expert layer over held experts, the grouped-product kernel, and the
DreamDDP plan over this model's uneven units.

On the CPU (float32, no JAX: the JAX package has no such model), against
the benchmark's plain reference (:mod:`perfbench.moe_reference`) on
seeded weights:

* the ``SMOKE`` model's logits, loss and every gradient of one step;
* the held dropless layer against a per-expert loop, with a batch routed
  wholly to one expert (nothing may drop) and a share held elsewhere;
* the share test: the shares of an 8-way split, with the shared experts
  counted once, sum to the uncut layer;
* MLA with ``q_lora_rank=None`` against the reference's;
* ``layer_costs`` of a held layer against :mod:`perfbench.moe_costs`, and
  the program's plan at the cell's sizes against :mod:`perfbench.moe_plan`;
* the compiled period bitwise the pipeline's, and ``routed_rows``.

On the card (``-m gpu``; skipped without CUDA): ``grouped_gemm`` against
its plain version in all three layouts at the cell's shapes, with empty
groups and a group holding every row (``torch._grouped_mm`` timed beside
it where the card's torch has it), and the bf16 smoke model's captured
period bitwise its eager pipeline.
"""

import dataclasses
import json
import math
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench import moe_costs, moe_plan, moe_reference  # noqa: E402
from perfbench.models import moe_decoder  # noqa: E402
from perfbench.moe_weights import flatten  # noqa: E402
from repro_torch.api import JobConfig, Session  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.moonlight_16b_a3b import SMOKE  # noqa: E402
from repro_torch.kernels.grouped_gemm import (grouped_gemm,  # noqa: E402
                                              grouped_gemm_ref, grouped_mm)
from repro_torch.models.mla import (MLAConfig, mla_apply_full,  # noqa: E402
                                    mla_init)
from repro_torch.models.moe import (HeldMoEConfig, RoutedRows,  # noqa: E402
                                    moe_apply, moe_init)
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

CELL_CONFIG = ROOT / "perfbench" / "configs" / "moonlight-16b-a3b-d9e8w4.json"
CELL_TRAFFIC = ROOT / "perfbench" / "traffic" / "dreamddp-moe-h5.json"
EPS = 1e-6                  # the port's RMSNorm eps (the config's assumed)


def _sizes(cfg) -> dict:
    """The harness's size dict of an ``LMConfig``."""
    mla, moe = cfg.mla, cfg.moe
    return {"n_layers": cfg.n_layers, "n_dense_layers": cfg.n_dense_layers,
            "d_model": cfg.d_model, "n_heads": mla.n_heads,
            "kv_lora_rank": mla.kv_lora_rank, "qk_nope_dim": mla.qk_nope_dim,
            "qk_rope_dim": mla.qk_rope_dim, "v_head_dim": mla.v_head_dim,
            "dense_ff": cfg.dense_d_ff, "expert_ff": moe.d_ff,
            "n_experts": moe.n_experts,
            "experts_held": moe.held, "top_k": moe.top_k,
            "n_shared": moe.n_shared, "routed_scale": moe.routed_scale,
            "vocab": cfg.vocab, "tie": cfg.tie_embeddings,
            "rope_theta": mla.rope_theta, "norm_eps": EPS,
            "dtype": cfg.param_dtype, "init_std": 0.02}


def _tokens(vocab, b, s, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (b, s), generator=g)


# --------------------------------------------------------------- the model

def test_smoke_against_the_reference():
    """Logits, loss and every gradient of one step: the port and the
    reference are both float32 on the same weights and differ by the
    order of sums (matmul blocking, the experts' grouped sums against a
    per-expert loop), ~1e-6 relative; 2e-4 leaves room for a near tie of
    two routing scores no wider than that."""
    model = DecoderLM(SMOKE)
    params = model.init(torch.Generator().manual_seed(3))
    m = _sizes(SMOKE)
    tokens = _tokens(SMOKE.vocab, 2, 24)
    flat = {p: t.detach().clone().requires_grad_()
            for p, t in flatten(params).items()}
    ref_logits = moe_reference.forward_logits(flat, tokens, m)
    ref_loss = moe_reference.xent(ref_logits, tokens)
    ref_grads = torch.autograd.grad(ref_loss, list(flat.values()))

    leaves = {p: t.detach().clone().requires_grad_()
              for p, t in flatten(params).items()}
    from perfbench.moe_weights import nest
    tree = nest(leaves)
    logits = model.apply(tree, tokens)
    loss = model.loss(tree, {"tokens": tokens, "labels": tokens})
    grads = torch.autograd.grad(loss, list(leaves.values()))

    scale = float(ref_logits.detach().abs().max())
    assert float((logits - ref_logits).abs().max()) <= 2e-4 * scale
    assert abs(float(loss) - float(ref_loss)) <= 2e-5 * abs(float(ref_loss))
    for (path, g), r in zip(leaves.items(), ref_grads, strict=True):
        gap = float((grads[list(leaves).index(path)] - r).norm())
        assert gap <= 2e-4 * max(float(r.norm()), 1e-6), path


def _layer(n_experts=8, top_k=2, d=32, f=16, n_shared=2, held=None,
           seed=0, dtype=torch.float32):
    cfg = HeldMoEConfig(n_experts=n_experts, top_k=top_k, d_ff=f,
                        n_shared=n_shared, router="sigmoid",
                        routed_scale=2.446, experts_held=held)
    p = moe_init(torch.Generator().manual_seed(seed), cfg, d, dtype=dtype)
    return cfg, p


def _ref_params(p):
    return {"router": p["router"]["w"], "gate": p["gate"], "up": p["up"],
            "down": p["down"], "s_gate": p["shared"]["gate"]["w"],
            "s_up": p["shared"]["up"]["w"], "s_down": p["shared"]["down"]["w"]}


def _ref_layer(cfg, p, x):
    m = {"top_k": cfg.top_k, "experts_held": cfg.held,
         "routed_scale": cfg.routed_scale}
    return moe_reference.moe_layer(x, _ref_params(p), m, None)


@pytest.mark.parametrize("case", ["random", "one_expert", "held_elsewhere"])
def test_held_layer_against_a_per_expert_loop(case):
    """The dropless layer equals the reference's per-expert loop
    (float32; 1e-5 of the output's scale is the order of sums).  In
    ``one_expert`` every token chooses held expert 3, whose group then
    holds every token's row: nothing is dropped.  ``held_elsewhere``
    holds experts 4-7 and routes half the choices elsewhere."""
    held = (4, 4) if case == "held_elsewhere" else None
    cfg, p = _layer(held=held)
    x = torch.randn(3, 20, 32, generator=torch.Generator().manual_seed(1))
    if case == "one_expert":
        p["router"]["w"][:, 3] = 0.0
        x[..., 0] = x[..., 0].abs() + 1.0
        p["router"]["w"][0, 3] = 50.0
    rows = RoutedRows(1, cfg.held[1])
    rows.arm(0)
    got = moe_apply(p, cfg, x, rows=rows, layer=0)
    want = _ref_layer(cfg, p, x)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    chosen = torch.topk(torch.sigmoid(x.reshape(-1, 32) @ p["router"]["w"]),
                        cfg.top_k).indices
    first, n = cfg.held
    counts = torch.stack([(chosen == first + j).sum() for j in range(n)])
    assert torch.equal(rows.total[0], counts)
    if case == "one_expert":
        assert int(rows.total[0, 3]) == 60 and int(rows.peak[0, 3]) == 60


def test_held_layer_gradients_against_the_reference():
    cfg, p = _layer(held=(2, 4))
    x = torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(2))
    leaves = {"x": x.clone().requires_grad_(),
              **{k: v.detach().clone().requires_grad_()
                 for k, v in flatten(p).items()}}
    from perfbench.moe_weights import nest
    tree = nest({k: v for k, v in leaves.items() if k != "x"})
    got = torch.autograd.grad(moe_apply(tree, cfg, leaves["x"]).square()
                              .sum(), list(leaves.values()))
    rl = {k: v.detach().clone().requires_grad_() for k, v in leaves.items()}
    rtree = nest({k: v for k, v in rl.items() if k != "x"})
    want = torch.autograd.grad(_ref_layer(cfg, rtree, rl["x"]).square()
                               .sum(), list(rl.values()))
    for name, a, b in zip(leaves, got, want, strict=True):
        assert float((a - b).norm()) <= 1e-5 * max(float(b.norm()), 1e-6), \
            name


def test_the_shares_add_up_to_the_uncut_layer():
    """Eight shares of two experts each, the shared experts counted
    once, give the layer that holds all 16 (float32)."""
    cfg, p = _layer(n_experts=16, top_k=4, seed=5)
    x = torch.randn(2, 24, 32, generator=torch.Generator().manual_seed(4))
    whole = moe_apply(p, cfg, x)
    total = torch.zeros_like(whole)
    for s in range(8):
        share = dataclasses.replace(cfg, experts_held=(2 * s, 2))
        ps = dict(p, gate=p["gate"][2 * s:2 * s + 2],
                  up=p["up"][2 * s:2 * s + 2],
                  down=p["down"][2 * s:2 * s + 2])
        total += moe_apply(ps, share, x)
    sh = p["shared"]
    only_shared = torch.nn.functional.silu(x @ sh["gate"]["w"]) \
        * (x @ sh["up"]["w"]) @ sh["down"]["w"]
    assert float((total - 7 * only_shared - whole).abs().max()) \
        <= 1e-5 * float(whole.abs().max())


def test_mla_without_query_lora_against_the_reference():
    cfg = MLAConfig(n_heads=4, q_lora_rank=None, kv_lora_rank=16,
                    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
                    rope_theta=50_000.0)
    p = mla_init(torch.Generator().manual_seed(7), cfg, 64,
                 dtype=torch.float32)
    assert set(p) == {"w_q", "w_dkv", "kv_norm", "w_uk", "w_uv", "w_o"}
    x = torch.randn(2, 40, 64, generator=torch.Generator().manual_seed(8))
    pos = torch.arange(40).expand(2, 40)
    got = mla_apply_full(p, cfg, x, pos)[0]
    m = {"n_heads": 4, "qk_nope_dim": 16, "qk_rope_dim": 8,
         "v_head_dim": 16, "kv_lora_rank": 16, "norm_eps": EPS,
         "rope_theta": 50_000.0}
    rp = {"w_q": p["w_q"], "w_dkv": p["w_dkv"],
          "kv_norm": p["kv_norm"]["scale"], "w_uk": p["w_uk"],
          "w_uv": p["w_uv"], "w_o": p["w_o"]}
    want = moe_reference.mla(x, rp, m, None)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


# ------------------------------------------------------- costs and the plan

def _cell():
    cfg = json.loads(CELL_CONFIG.read_text())
    job = json.loads(CELL_TRAFFIC.read_text())["job"]
    model, m = moe_decoder.program_model(cfg)
    return cfg, job, model, m


def test_layer_costs_of_a_held_layer():
    """The program charges each unit what the benchmark's frozen
    arithmetic does: a held layer its 8 experts' bytes, its active
    FLOPs at the expected routed rows."""
    cfg, job, model, m = _cell()
    got = model.layer_costs(job["batch_per_worker"], job["seq"])
    want = moe_costs.unit_costs(m, job["batch_per_worker"], job["seq"])
    assert [(p, f) for _, p, f in got] == want
    # the published sizes: ~970M a worker (41.9M + 83.0M + 8 x 100.4M +
    # 41.9M) and ~1.23 GFLOP a token forward
    assert abs(sum(p for p, _ in want) / 1e6 - 970.0) < 2.0
    tokens = job["batch_per_worker"] * job["seq"]
    assert abs(sum(f for _, f in want[1:]) / tokens / 1e9 - 1.228) < 0.01


@pytest.mark.parametrize("workers", [4, 8])
def test_the_plan_is_the_papers_at_the_cells_sizes(workers):
    cfg, job, model, m = _cell()
    sess = Session(JobConfig(
        arch=cfg["name"], algo="dreamddp", workers=workers,
        period=job["period"], batch_per_worker=job["batch_per_worker"],
        seq=job["seq"], bandwidth=job["plan"]["bandwidth"],
        latency=job["plan"]["latency"]), model=model, device="cpu")
    got = [tuple(u) for u in sess.plan.phase_units]
    assert got == moe_plan.phase_units(m, job, workers)


def test_the_published_config_builds():
    model = get_arch("moonlight-16b-a3b").make_model()
    assert 15.9e9 < model.param_count() < 16.0e9
    assert 2.8e9 < model.active_param_count() < 3.0e9


# ------------------------------------------------------------ training

def _session(device, exec_, dtype="float32", steps=4):
    model = DecoderLM(dataclasses.replace(SMOKE, param_dtype=dtype))
    sess = Session(JobConfig(arch="moonlight-16b-a3b", smoke=True,
                             algo="dreamddp", workers=2, period=2, seq=16,
                             batch_per_worker=2, period_exec=exec_),
                   model=model, device=device)
    return sess.fit(steps)


def _leaves(state):
    return [x for x in tree_leaves(state._asdict()) if x is not None]


def _bitwise(device, dtype):
    pipe = _session(device, "pipeline", dtype)
    comp = _session(device, "compiled", dtype)
    for a, b in zip(_leaves(pipe.state), _leaves(comp.state), strict=True):
        assert torch.equal(a, b)
    assert [h["loss"] for h in pipe.history] == \
        [h["loss"] for h in comp.history]
    assert all(math.isfinite(h["loss"]) for h in comp.history)
    return pipe, comp


def test_compiled_is_bitwise_the_pipeline_cpu():
    pipe, comp = _bitwise("cpu", "float32")
    # every (token, choice) pair held: 4 steps x 2 workers x 32 tokens x
    # 2 choices x 2 MoE layers
    rows = comp.model.routed_rows
    assert int(rows.total.sum()) == 4 * 2 * 32 * 2 * 2
    assert rows.total.shape == (2, 8)


# ------------------------------------------------------------ on the card

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the grouped kernel runs on the "
                    "card)")
    return torch.device("cuda")


def _groups(kind, M, G, gen):
    """Offsets [G + 1] of ``kind``: ~M / (8 G) rows a group (an eighth of
    the pairs held), some empty groups, or one group with every row."""
    if kind == "all_in_one":
        counts = [0] * G
        counts[G // 2] = M
    else:
        counts = torch.randint(M // (10 * G), M // (6 * G), (G,),
                               generator=gen).tolist()
        if kind == "empty":
            counts[0] = counts[3] = counts[G - 1] = 0
    offs = [0]
    for c in counts:
        offs.append(offs[-1] + c)
    return torch.tensor(offs, dtype=torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["fwd", "dgrad", "wgrad"])
@pytest.mark.parametrize("shape", [(2048, 2816), (1408, 2048)],
                         ids=["gate_up", "down"])
@pytest.mark.parametrize("kind", ["routed", "empty", "all_in_one"])
def test_grouped_gemm_against_plain(cuda, layout, shape, kind):
    """The kernel against the plain per-group product in float32 of the
    same bf16 operands, at the cell's shapes (T k = 8192 x 6 rows, 8 held
    experts): bf16 outputs are within 2^-7 of the largest; rows past the
    last group, and an empty group's dW, are exactly zero."""
    K, N = shape
    M, G = 8192 * 6, 8
    gen = torch.Generator().manual_seed(11)
    offs = _groups(kind, M, G, gen).to(cuda)
    a = torch.randn(M, K if layout != "dgrad" else N, generator=gen) \
        .to(cuda, torch.bfloat16)
    b = (torch.randn(G, K, N, generator=gen) * 0.02 if layout != "wgrad"
         else torch.randn(M, N, generator=gen)).to(cuda, torch.bfloat16)
    got = grouped_gemm(a, b, offs, layout, impl="cuda").float()
    want = grouped_gemm_ref(a.float(), b.float(), offs, layout)
    scale = float(want.abs().max()) or 1.0
    assert float((got - want).abs().max()) <= 2 ** -7 * scale
    end = int(offs[-1])
    if layout != "wgrad":
        assert not got[end:].any()
    else:
        for g in range(G):
            if offs[g] == offs[g + 1]:
                assert not got[g].any()
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_grouped_mm_backward_against_plain(cuda):
    gen = torch.Generator().manual_seed(12)
    offs = _groups("empty", 4096, 8, gen).to(cuda)
    x = torch.randn(4096, 256, generator=gen).to(cuda, torch.bfloat16)
    w = (torch.randn(8, 256, 384, generator=gen) * 0.05).to(
        cuda, torch.bfloat16)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    grouped_mm(xa, wa, offs).float().square().sum().backward()
    xr, wr = x.float().requires_grad_(), w.float().requires_grad_()
    grouped_mm(xr, wr, offs.cpu(), impl="ref").square().sum().backward()
    for got, want in ((xa.grad, xr.grad), (wa.grad, wr.grad)):
        assert float((got.float() - want).abs().max()) \
            <= 2 ** -6 * float(want.abs().max())


@pytest.mark.gpu
def test_library_grouped_mm_timed_beside_the_kernel(cuda):
    """Times ``torch._grouped_mm`` where the card's torch has it, beside
    the kernel, at the gate-up shape (printed; no assertion on speed)."""
    gen = torch.Generator().manual_seed(13)
    M, G, K, N = 8192 * 6, 8, 2048, 2816
    offs = _groups("routed", M, G, gen).to(cuda)
    a = torch.randn(M, K, generator=gen).to(cuda, torch.bfloat16)
    b = (torch.randn(G, K, N, generator=gen) * 0.02).to(cuda, torch.bfloat16)

    def timed(fn, n=20):
        fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(n):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / n

    ms = timed(lambda: grouped_gemm(a, b, offs, "fwd", impl="cuda"))
    lib = getattr(torch, "_grouped_mm", None)
    lib_ms = None
    if lib is not None:
        end = int(offs[-1])
        try:
            lib_ms = timed(lambda: lib(a[:end], b, offs=offs[1:]))
        except RuntimeError as e:
            lib_ms = f"refused: {e}"
    print(f"grouped_gemm fwd {ms:.4f} ms, torch._grouped_mm {lib_ms}")
    assert ms > 0


@pytest.mark.gpu
def test_captured_period_is_bitwise_the_eager_one(cuda):
    pipe, comp = _bitwise(cuda, "bfloat16")
    stats = comp.runner.graph_stats
    assert stats.graphs == 1 and stats.replays[()] == 1
    assert stats.captured_launches[()]["grouped_gemm"] > 0
    rows = comp.model.routed_rows
    assert int(rows.total.sum()) == 4 * 2 * 32 * 2 * 2
