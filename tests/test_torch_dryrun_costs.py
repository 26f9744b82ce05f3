"""The dry run's op counter and serve steps against the JAX package.

* **FLOPs** — :class:`~repro_torch.analysis.op_costs.OpCounter` over the
  port's smoke train (2 workers x 2 x 32 tokens, AdamW, the dreamddp
  plan's phase 0), prefill (2 x 32) and decode (lanes of 40) steps of
  granite, mamba2 and whisper on CPU tensors, against
  ``parse_module_costs(jax.jit(step).lower(...).compile().as_text())
  .flops`` on one CPU device.  Read off both: remat recomputes the same
  forward products on both sides, and the dense attention of decode
  and the lanes of prefill (as deep as the prompt here) are the same
  products, so the counts are **equal**, but for mamba2's training
  step, whose four-operand SSD einsums each library contracts in its own
  order: there the port counts within 0.5% of JAX (0.2% fewer, read).
  None of these archs has the MoE dense dispatch.
* **Meta against CPU** — the same steps traced on ``meta`` tensors: the
  FLOPs outside the kernels equal the CPU trace's outside the kernels'
  plain versions exactly; each kernel's formula (the work it does) is
  held to its plain version's matmul FLOPs: paged equal (every page at
  its most), flash's causal launches at the (query, key) pairs of the
  triangle (the plain version computes the square), non-causal equal,
  the SSD chunk kernel's lower triangle between half and all of the
  plain version's.
* **Serve steps** — ``make_prefill_step`` and ``make_decode_step``
  logits against the reference's on the same parameters (the port's
  init carried to JAX as numpy) and inputs, within ``TOL``, the model
  tests' tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.analysis.hlo_costs import parse_module_costs  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.core import HardwareSpec as JHW  # noqa: E402
from repro.core import analytic_profile as jprofile  # noqa: E402
from repro.core import build_plan as jbuild_plan  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro.runtime import step as jstep  # noqa: E402
from repro_torch.analysis.op_costs import OpCounter  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.convert import params_to_numpy  # noqa: E402
from repro_torch.core import (HardwareSpec, analytic_profile,  # noqa: E402
                              build_plan)
from repro_torch.kernels._cost import causal_pairs  # noqa: E402
from repro_torch.models.layers import MetaGenerator, param_shapes  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.runtime import step as tstep  # noqa: E402

torch.set_num_threads(1)

ARCH_IDS = ("granite-3-2b", "mamba2-780m", "whisper-medium")
W, B, S, DEPTH = 2, 2, 32, 40
TOL = 1e-4
# the port's count over JAX's: equal but for mamba2's training step
FLOP_RATIO = {("mamba2-780m", "train"): (0.995, 1.0)}


def _inputs(arch_id):
    """Port smoke model, JAX smoke model, tokens [W, B, S] and frames
    (whisper) from a seed."""
    tm, jm = ARCHS[arch_id].make_smoke(), JARCHS[arch_id].make_smoke()
    cfg = tm.cfg
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (W, B, S)).astype(np.int32)
    frames = None
    if ARCHS[arch_id].frontend == "audio":
        frames = rng.standard_normal(
            (W, B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return tm, jm, toks, frames


def _plans(tm, jm):
    tp = build_plan("dreamddp", analytic_profile(tm.layer_costs(1, S),
                                                 HardwareSpec(n_workers=W)),
                    5)
    jp = jbuild_plan("dreamddp", jprofile(jm.layer_costs(1, S),
                                          JHW(n_workers=W)), 5)
    assert tp.fingerprint() == jp.fingerprint()
    return tp, jp


def _batch(toks, frames, lib):
    batch = {"tokens": toks, "labels": toks}
    if frames is not None:
        batch["frames"] = frames
    if lib == "jax":
        return {k: jnp.asarray(v) for k, v in batch.items()}
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_args(arch_id, kind, tm, toks, frames, meta=False):
    """The port step and its arguments, real (CPU) or ``meta``."""
    if kind == "train":
        tplan, _ = _plans(tm, JARCHS[arch_id].make_smoke())
        opt = make_optimizer("adamw", lr=3e-4)
        gen = MetaGenerator() if meta else torch.Generator().manual_seed(0)
        state = tstep.init_train_state(tm, opt, gen, W)
        batch = _batch(toks, frames, "torch")
        if meta:
            batch = {k: v.to("meta") for k, v in batch.items()}
        return tstep.make_train_step(tm, opt, tplan, 0), (state, batch)
    dev = "meta" if meta else "cpu"
    params = param_shapes(tm) if meta else \
        tm.init(torch.Generator().manual_seed(0))
    depth = S if kind == "prefill" else DEPTH
    cache = tm.init_cache(B, depth, device=dev)
    if kind == "prefill":
        extra = () if frames is None else \
            (torch.from_numpy(frames[0]).to(dev),)
        return (tstep.make_prefill_step(
            tm, with_frontend=ARCHS[arch_id].frontend),
            (params, torch.from_numpy(toks[0]).to(dev), cache, *extra))
    tok = torch.from_numpy(toks[0, :, :1]).to(dev)
    pos = torch.full((B,), S, dtype=torch.int32, device=dev)
    return tstep.make_decode_step(tm), (params, cache, tok, pos)


def _jax_flops(arch_id, kind, jm, toks, frames) -> float:
    if kind == "train":
        _, jplan = _plans(ARCHS[arch_id].make_smoke(), jm)
        opt = jmake_optimizer("adamw", lr=3e-4)
        state = jstep.init_train_state(jm, opt, jax.random.PRNGKey(0), W)
        fn = jstep.make_train_step(jm, opt, jplan, 0)
        args = (state, _batch(toks, frames, "jax"))
    else:
        params = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        depth = S if kind == "prefill" else DEPTH
        cache = jax.eval_shape(lambda: jm.init_cache(B, depth))
        if kind == "prefill":
            fn = jstep.make_prefill_step(
                jm, with_frontend=JARCHS[arch_id].frontend)
            extra = () if frames is None else (jnp.asarray(frames[0]),)
            args = (params, jnp.asarray(toks[0]), cache, *extra)
        else:
            fn = jstep.make_decode_step(jm)
            args = (params, cache, jnp.asarray(toks[0, :, :1]),
                    jnp.full((B,), S, jnp.int32))
    text = jax.jit(fn).lower(*args).compile().as_text()
    return parse_module_costs(text).flops


CASES = [(a, k) for a in ARCH_IDS for k in ("train", "prefill", "decode")]


@pytest.mark.parametrize("arch_id,kind", CASES)
def test_flops_against_jax_and_meta(arch_id, kind):
    tm, jm, toks, frames = _inputs(arch_id)
    fn, args = _port_args(arch_id, kind, tm, toks, frames)
    with OpCounter() as cpu:
        fn(*args)
    want = _jax_flops(arch_id, kind, jm, toks, frames)
    lo, hi = FLOP_RATIO.get((arch_id, kind), (1.0, 1.0))
    assert lo * want <= cpu.costs.flops <= hi * want, \
        (cpu.costs.flops, want)

    # the same step on meta tensors: kernels as single ops
    fn, args = _port_args(arch_id, kind, tm, toks, frames, meta=True)
    with OpCounter() as meta:
        fn(*args)
    kernel_dots = sum(r[1] for r in meta.kernels.values())
    assert meta.costs.flops - kernel_dots \
        == cpu.costs.flops - sum(cpu.plain_dot_flops.values())
    assert set(meta.kernels) == set(cpu.plain_dot_flops) | (
        {"fused_adamw"} if kind == "train" else set())
    for name, (calls, dots, flops, nbytes) in meta.kernels.items():
        plain = cpu.plain_dot_flops.get(name, 0.0)
        assert calls > 0 and nbytes > 0 and flops >= dots
        if name in ("paged_attention", "fused_adamw"):
            assert dots == plain
        elif name == "ssd_chunk_grouped":
            assert 0.5 * plain <= dots <= plain
    if "flash_attention" in meta.kernels:
        # causal self-attention over the prompt: the triangle of pairs
        tri = causal_pairs(S, S, True, None) / (S * S)
        dots = meta.kernels["flash_attention"][1]
        plain = cpu.plain_dot_flops["flash_attention"]
        if arch_id == "granite-3-2b":
            assert dots == plain * tri
        else:       # whisper: encoder and cross non-causal, self causal
            cfg = tm.cfg
            per_row = 4 * B * cfg.n_heads * cfg.hd
            self_attn = per_row * S * S * cfg.n_dec_layers
            assert dots == plain - self_attn * (1 - tri)
    assert meta.costs.bytes_accessed > 0 and meta.peak_bytes > 0


@pytest.mark.parametrize("arch_id", ARCH_IDS + ("llava-next-34b",))
def test_serve_steps_against_jax(arch_id):
    """Prefill then one decode step: the port's step functions against
    the reference's on the same parameters and inputs."""
    tm, jm, toks, frames = _inputs(arch_id)
    frontend = ARCHS[arch_id].frontend
    params = tm.init(torch.Generator().manual_seed(0))
    jparams = jax.tree.map(jnp.asarray, params_to_numpy(params))
    extra_t, extra_j, prefix = (), (), 0
    if frontend == "audio":
        extra_t = (torch.from_numpy(frames[0]),)
        extra_j = (jnp.asarray(frames[0]),)
    elif frontend == "vision":
        prefix = 4
        emb = np.random.default_rng(1).standard_normal(
            (B, prefix, tm.cfg.d_model)).astype(np.float32)
        extra_t, extra_j = (torch.from_numpy(emb),), (jnp.asarray(emb),)
    depth = S + prefix + 8
    cache = tm.init_cache(B, depth, device="cpu")
    got, cache = tstep.make_prefill_step(tm, with_frontend=frontend)(
        params, torch.from_numpy(toks[0]), cache, *extra_t)
    want, jcache = jstep.make_prefill_step(jm, with_frontend=frontend)(
        jparams, jnp.asarray(toks[0]), jm.init_cache(B, depth), *extra_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    tok = toks[1, :, :1]
    pos = np.full((B,), S + prefix, np.int32)
    got, _ = tstep.make_decode_step(tm)(params, cache, torch.from_numpy(tok),
                                        torch.from_numpy(pos))
    want, _ = jstep.make_decode_step(jm)(jparams, jcache, jnp.asarray(tok),
                                         jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_meta_trace_allocates_nothing():
    """A full-width cell's step on meta tensors (granite-3-2b, 40 layers,
    a one-device mesh): the outputs are meta, the flash wrapper counts no
    launch but reports one kernel op a layer, and no CUDA context
    exists."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.cells import build_prefill_cell
    from repro_torch.launch.mesh import MeshSpec

    cell = build_prefill_cell(ARCHS["granite-3-2b"],
                              ShapeSpec("card_prefill", 64, 2, "prefill"),
                              MeshSpec((1, 1), ("data", "model")),
                              multi_pod=False)
    before = flash_attention.launches
    counter, (logits, _) = cell.trace()
    assert flash_attention.launches == before
    assert counter.kernels["flash_attention"][0] == 40
    assert logits.is_meta and tuple(logits.shape) == (2, 1, 49155)
    assert cell.arg_bytes() > 5e9 and not torch.cuda.is_initialized()
