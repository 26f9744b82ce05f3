"""The port's decoder LM against the JAX package's, on the same params.

granite-3-2b ``SMOKE`` (4 layers, d_model 64, 8/2 heads, head_dim 8,
vocab 512, float32), a variant taking the branches granite does not, and
the ``SMOKE`` configs of qwen3-moe-30b-a3b (MoE), qwen3-1.7b (qk-norm),
phi4-mini-3.8b (GQA group 3), qwen2.5-32b (QKV bias, untied head) and
deepseek-v3-671b (MLA latent caches, multi-token prediction in the loss):
JAX ``DecoderLM(SMOKE).init(PRNGKey(0))`` is carried into the port with
``params_from_numpy`` and both models run the same numpy-made inputs.
Tolerance ``atol=rtol=1e-4``: float32 matmuls sum in a different order
in XLA:CPU and in torch, compounded over 3-4 layers (the MoE smoke's
outputs agree so only while no expert choice flips between the two).
Gradients are held to the same.  ``unit_layout``, ``layer_costs`` and
the full configs' ``param_count`` are equal exactly.  The layer
primitives alone are held to ``1e-5``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import granite_3_2b as jax_granite  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.configs import ARCHS, get_arch, granite_3_2b  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.kernels.paged_attention import \
    write_token_to_pages  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.transformer import DecoderLM, LMConfig  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-4


def _close(a, b, tol=TOL):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)
    np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=tol,
                               atol=tol)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# the branches granite does not take: qkv bias, qk-norm, LayerNorm, GELU,
# a local window (prefill through flash's window mask) and an untied head
_VARIANT = dict(name="variant", n_layers=2, d_model=32, n_heads=4,
                n_kv_heads=2, d_ff=64, vocab=128, head_dim=8, qkv_bias=True,
                qk_norm=True, mlp_kind="gelu", norm_kind="layernorm",
                tie_embeddings=False, window=5, param_dtype="float32")


# the archs this file holds at their SMOKE configs beside granite's
NEW_ARCHS = ["qwen3-moe-30b-a3b", "qwen3-1.7b", "phi4-mini-3.8b",
             "qwen2.5-32b", "deepseek-v3-671b"]
# published sizes, counted by the reference's formulas
FULL_PARAMS = {"granite-3-2b": 2_533_531_648,
               "qwen3-moe-30b-a3b": 30_532_122_624,
               "qwen3-1.7b": 1_720_574_976,
               "phi4-mini-3.8b": 3_836_021_760,
               "qwen2.5-32b": 32_763_876_352,
               "deepseek-v3-671b": 682_636_457_984,
               "llava-next-34b": 34_388_917_248,
               "whisper-medium": 792_032_256}
# the frontends' archs, held whole in tests/test_torch_vision.py and
# tests/test_torch_whisper.py; here their configs and counts
FRONTEND_ARCHS = ["llava-next-34b", "whisper-medium"]


def _make_pair(name):
    from repro.models.transformer import DecoderLM as JDecoderLM
    from repro.models.transformer import LMConfig as JConfig
    if name == "granite-smoke":
        jm, tm = JDecoderLM(jax_granite.SMOKE), DecoderLM(granite_3_2b.SMOKE)
    elif name == "variant":
        jm, tm = JDecoderLM(JConfig(**_VARIANT)), DecoderLM(LMConfig(**_VARIANT))
    else:
        jm, tm = jget_arch(name).make_smoke(), get_arch(name).make_smoke()
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    return jm, jp, tm, params_from_numpy(jp, "cpu")


@pytest.fixture(scope="module")
def granite():
    return _make_pair("granite-smoke")


@pytest.fixture(scope="module",
                params=["granite-smoke", "variant", *NEW_ARCHS])
def pair(request):
    return _make_pair(request.param)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", ["granite-3-2b", *NEW_ARCHS,
                                  *FRONTEND_ARCHS])
@pytest.mark.parametrize("name", ["CONFIG", "SMOKE"])
def test_config_matches_reference(arch, name):
    make = {"CONFIG": "make_model", "SMOKE": "make_smoke"}[name]
    ours = dataclasses.asdict(getattr(get_arch(arch), make)().cfg)
    theirs = dataclasses.asdict(getattr(jget_arch(arch), make)().cfg)
    # the reference never reads attn_impl (ROADMAP C3); the port's prefill
    # always runs the flash kernel, so its config has no such field
    theirs.pop("attn_impl", None)
    assert ours == theirs
    assert get_arch(arch).family == jget_arch(arch).family


def test_unported_archs_and_features_raise():
    # every arch of the reference is ported; an unknown id still raises
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("llava-next-35b")
    assert sorted(ARCHS) == sorted(JARCHS)


@pytest.mark.parametrize("arch", sorted(FULL_PARAMS))
def test_full_config_param_count_matches_reference(arch):
    """Counted from the configs alone: nothing is initialised."""
    ours = get_arch(arch).make_model()
    theirs = jget_arch(arch).make_model()
    assert ours.param_count() == theirs.param_count() == FULL_PARAMS[arch]
    assert ours.active_param_count() == theirs.active_param_count()
    for mode in ("train", "decode"):
        assert ours.layer_costs(8, 512, mode=mode) == \
            theirs.layer_costs(8, 512, mode=mode)


# ---------------------------------------------------------------- convert

def test_params_round_trip_bitwise(pair):
    _, jp, _, tp = pair
    back = params_to_numpy(tp)
    a, b = _flat(jp), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_bf16_goes_through_f32_exactly():
    x = jax.device_get(jax.random.normal(jax.random.PRNGKey(1), (5, 7),
                                         jnp.bfloat16))
    t = params_from_numpy({"w": x}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    back = params_to_numpy({"w": t})["w"]
    np.testing.assert_array_equal(back, np.asarray(x, np.float32))
    assert params_from_numpy({"w": back}, "cpu", torch.bfloat16)["w"] \
        .equal(t)


def test_init_layout_and_param_count_match_reference(granite):
    jm, jp, tm, _ = granite
    ours = _flat(tm.init(torch.Generator().manual_seed(0)))
    theirs = _flat(jp)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert tuple(ours[k].shape) == theirs[k].shape, k
        assert ours[k].dtype == torch.float32
    assert tm.param_count() == jm.param_count() \
        == sum(v.size for v in theirs.values())
    full = granite_3_2b.ARCH.make_model()
    assert full.param_count() == jax_granite.ARCH.make_model().param_count()


# ---------------------------------------------------------------- layers

def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, np.float32)


def test_rms_norm_rounds_like_the_reference_in_bf16():
    x, scale = _rand(0, 3, 5, 64), _rand(1, 64)
    got = tl.rms_norm({"scale": torch.from_numpy(scale).bfloat16()},
                      torch.from_numpy(x).bfloat16())
    want = jl.rms_norm({"scale": jnp.asarray(scale, jnp.bfloat16)},
                       jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("fn", ["rms_norm", "layer_norm", "rope",
                                "mlp_swiglu", "mlp_gelu", "xent"])
def test_layer_primitives_match_reference(fn):
    x = _rand(2, 2, 6, 4, 16)
    if fn in ("rms_norm", "layer_norm"):
        p = {"scale": _rand(3, 16), "bias": _rand(4, 16)}
        got = getattr(tl, fn)({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x))
        want = getattr(jl, fn)(p, jnp.asarray(x))
    elif fn == "rope":
        pos = np.arange(12, dtype=np.int32).reshape(2, 6)
        got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            tl.rope_freqs(16, 1e4))
        want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                             jl.rope_freqs(16, 1e4))
    elif fn.startswith("mlp"):
        kind = fn.split("_")[1]
        names = ("gate", "up", "down") if kind == "swiglu" else ("up", "down")
        p = {n: {"w": _rand(5 + i, *((16, 32) if n != "down" else (32, 16)))
                 * (16 if n != "down" else 32) ** -0.5}
             for i, n in enumerate(names)}
        got = tl.mlp_apply(
            {n: {"w": torch.from_numpy(v["w"])} for n, v in p.items()},
            torch.from_numpy(x), kind=kind)
        want = jl.mlp_apply(p, jnp.asarray(x), kind=kind)
    else:
        logits = _rand(6, 3, 5, 11)
        labels = np.array([[1, 2, -100, 4, 0]] * 3, np.int32)
        got = tl.softmax_xent(torch.from_numpy(logits),
                              torch.from_numpy(labels))
        want = jl.softmax_xent(jnp.asarray(logits), jnp.asarray(labels))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("window,q_chunk,valid", [
    (None, 1024, False), (3, 1024, False), (None, 4, True), (5, 4, True)])
def test_gqa_attention_matches_reference(window, q_chunk, valid):
    b, sq, sk, nq, nkv, hd = 2, 10, 10, 4, 2, 8
    q, k, v = _rand(7, b, sq, nq, hd), _rand(8, b, sk, nkv, hd), \
        _rand(9, b, sk, nkv, hd)
    kvl = np.array([7, 10], np.int32) if valid else None
    got = tl.gqa_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), window=window,
                           q_chunk=q_chunk,
                           kv_valid_len=None if kvl is None
                           else torch.from_numpy(kvl))
    want = jl.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            window=window, q_chunk=q_chunk,
                            kv_valid_len=None if kvl is None
                            else jnp.asarray(kvl))
    _close(got, want, 1e-5)


# ---------------------------------------------------------------- the model

def test_apply_logits_match(pair):
    jm, jp, tm, tp = pair
    toks = _tokens(0, (2, 12), tm.cfg.vocab)
    _close(tm.apply(tp, torch.from_numpy(toks)),
           jm.apply(jp, jnp.asarray(toks)))


def test_loss_and_grads_match(pair):
    """Training forward (remat on, as the configs set it) and backward."""
    jm, jp, tm, tp = pair
    toks = _tokens(7, (2, 12), tm.cfg.vocab)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(jp, jbatch)
    tp = tree_map(lambda x: x.detach().clone().requires_grad_(), tp)
    t = torch.from_numpy(toks).long()
    loss = tm.loss(tp, {"tokens": t, "labels": t})
    loss.backward()
    _close(loss, jloss)
    got, want = _flat(tree_map(lambda x: x.grad, tp)), \
        _flat(jax.device_get(jgrads))
    assert got.keys() == want.keys()
    for k in got:
        _close(got[k], want[k])


def test_unit_layout_and_layer_costs_match(pair):
    jm, _, tm, tp = pair
    assert [dataclasses.astuple(e) for e in tm.unit_layout().entries] == \
        [dataclasses.astuple(e) for e in jm.unit_layout().entries]
    tm.unit_layout().validate_against(tp, worker_stacked=False)
    for mode in ("train", "decode"):
        assert tm.layer_costs(2, 16, mode=mode) == \
            jm.layer_costs(2, 16, mode=mode)
    assert tm.param_count() == jm.param_count()
    if tm.cfg.norm_kind == "rmsnorm":   # the count leaves out a LayerNorm
        assert tm.param_count() == tl.count_params(tp)  # head's bias
    assert tm.active_param_count() == jm.active_param_count()


def _prefilled(pair, b=2, s=9, max_seq=16):
    jm, jp, tm, tp = pair
    toks = _tokens(1, (b, s), tm.cfg.vocab)
    jl_, jc = jm.prefill(jp, jnp.asarray(toks), jm.init_cache(b, max_seq))
    tl_, tc = tm.prefill(tp, torch.from_numpy(toks),
                         tm.init_cache(b, max_seq, device="cpu"))
    return (jl_, jc), (tl_, tc)


def test_prefill_logits_and_cache_match(pair):
    (jlog, jc), (tlog, tc) = _prefilled(pair)
    assert tuple(tlog.shape) == jlog.shape
    _close(tlog, jlog)
    assert tc.keys() == jc.keys()
    for group in tc:
        assert tc[group].keys() == jc[group].keys()
        for name in tc[group]:
            _close(tc[group][name], jc[group][name])


def test_decode_step_matches(pair):
    jm, jp, tm, tp = pair
    (_, jc), (_, tc) = _prefilled(pair)
    tok = _tokens(2, (2, 1), tm.cfg.vocab)
    pos = np.full((2,), 9, np.int32)
    jlog, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
    tlog, tc = tm.decode_step(tp, tc, torch.from_numpy(tok),
                              torch.from_numpy(pos))
    _close(tlog, jlog)
    for group in tc:
        for name in tc[group]:
            _close(tc[group][name], jc[group][name])


def test_decode_step_per_lane_positions_match_vmapped_reference(pair):
    """Lanes at different positions: the port's decode writes each lane
    at its own position, as the reference's slot-vmapped step does."""
    from repro.runtime.step import make_slot_decode_step
    jm, jp, tm, tp = pair
    (_, jc), (_, tc) = _prefilled(pair)
    tok = _tokens(3, (2,), tm.cfg.vocab)
    pos = np.array([9, 5], np.int32)
    jlog, jc = jax.jit(make_slot_decode_step(jm))(
        jp, jc, jnp.asarray(tok), jnp.asarray(pos))
    tlog, tc = tm.decode_step(tp, tc, torch.from_numpy(tok)[:, None],
                              torch.from_numpy(pos))
    _close(tlog[:, 0], jlog)
    for group in tc:
        for name in tc[group]:
            _close(tc[group][name], jc[group][name])


def test_decode_step_paged_matches(pair):
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    rng = np.random.default_rng(4)
    slots, ps, mb = 3, 4, 3
    n_pages = 1 + slots * mb
    # random pages of the model's own layout (GQA k/v or MLA latents)
    pages = {group: {n: rng.standard_normal(tuple(t.shape), np.float32)
                     for n, t in leaves.items()}
             for group, leaves in tm.init_paged_cache(
                 n_pages, ps, device="meta").items()}
    bt = rng.permutation(np.arange(1, n_pages)).reshape(slots, mb) \
        .astype(np.int32)
    pos = np.array([5, 11, 0], np.int32)
    active = np.array([True, True, False])
    tok = _tokens(5, (slots, 1), cfg.vocab)

    jlog, jpages = jm.decode_step_paged(
        jp, jax.tree.map(jnp.asarray, pages), jnp.asarray(tok),
        jnp.asarray(pos), jnp.asarray(bt), jnp.asarray(active))
    tlog, tpages = tm.decode_step_paged(
        tp, params_from_numpy(pages, "cpu"), torch.from_numpy(tok),
        torch.from_numpy(pos), torch.from_numpy(bt),
        torch.from_numpy(active))
    _close(tlog, jlog)
    for group in pages:
        for name in pages[group]:
            # page 0 is the trash page: written, never read
            _close(tpages[group][name][:, 1:],
                   np.asarray(jpages[group][name])[:, 1:])


def test_write_token_to_pages_gates_inactive_lanes():
    pages = torch.zeros(4, 2, 1, 1)
    bt = torch.tensor([[1, 2], [3, 1]], dtype=torch.int32)
    write_token_to_pages(pages, bt, torch.tensor([3, 0], dtype=torch.int32),
                         torch.tensor([True, False]),
                         torch.tensor([[[7.0]], [[9.0]]]))
    assert pages[2, 1].item() == 7.0          # block 1, offset 1
    assert pages[0, 0].item() == 9.0          # inactive: trash page
    assert pages[3].abs().sum() == 0


def test_bf16_model_runs_in_bf16():
    cfg = dataclasses.replace(granite_3_2b.SMOKE, param_dtype="bfloat16")
    m = DecoderLM(cfg)
    p = m.init(torch.Generator().manual_seed(0))
    logits, cache = m.prefill(p, torch.from_numpy(_tokens(6, (2, 5),
                                                          cfg.vocab)),
                              m.init_cache(2, 8, device="cpu"))
    assert logits.dtype == torch.bfloat16 and tuple(logits.shape) == (
        2, 1, cfg.vocab)
    assert torch.isfinite(logits.float()).all()
    assert cache["blocks"]["k"].dtype == torch.bfloat16


def test_lmconfig_dtype_is_torch():
    assert LMConfig("x", 1, 8, 2, 1, 16, 10).dtype == torch.bfloat16
