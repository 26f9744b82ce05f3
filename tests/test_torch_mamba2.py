"""The port's Mamba-2 against the JAX package's, on the same params.

mamba2 ``SMOKE`` (3 layers, d_model 48, 12 heads x head_dim 8, d_state
16, chunk 8, vocab 384, float32): JAX ``Mamba2LM(SMOKE).init(PRNGKey(0))``
is carried into the port with ``params_from_numpy`` and both models run
the same numpy-made tokens.  Tolerance ``atol=rtol=1e-4``, as for the
dense model: float32 sums in another order in XLA:CPU and in torch,
compounded over the layers.  On the CPU the port's prefill runs the SSD
chunk kernel's plain version; the reference runs its einsum oracle.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import mamba2_780m as jax_mamba  # noqa: E402
from repro_torch.configs import get_arch, mamba2_780m  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunk_grouped  # noqa: E402
from repro_torch.models import Mamba2LM  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-4


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def pair():
    jm = jax_mamba.ARCH.make_smoke()
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    return jm, jp, Mamba2LM(mamba2_780m.SMOKE), params_from_numpy(jp, "cpu")


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        0, mamba2_780m.SMOKE.vocab, shape, dtype=np.int32)


# ------------------------------------------------------------ structure

@pytest.mark.parametrize("name", ["CONFIG", "SMOKE"])
def test_config_matches_reference(name):
    assert dataclasses.asdict(getattr(mamba2_780m, name)) \
        == dataclasses.asdict(getattr(jax_mamba, name))
    assert get_arch("mamba2-780m").make_smoke().cfg == mamba2_780m.SMOKE


def test_init_layout_and_dtypes_match_reference(pair):
    _, jp, tm, _ = pair
    ours = _flat(tm.init(torch.Generator().manual_seed(0)))
    theirs = _flat(jp)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert tuple(ours[k].shape) == theirs[k].shape, k
        assert str(ours[k].dtype).removeprefix("torch.") \
            == theirs[k].dtype.name, k
    full = Mamba2LM(mamba2_780m.CONFIG)
    assert full.cfg.dtype == torch.bfloat16


def test_structure_matches_reference(pair):
    jm, jp, tm, tp = pair
    assert tm.param_count() == jm.param_count() \
        == sum(v.size for v in _flat(jp).values()) \
        == sum(v.numel() for v in _flat(tp).values())
    assert tm.active_param_count() == jm.active_param_count()
    assert [(e.name, e.group, e.index) for e in tm.unit_layout().entries] \
        == [(e.name, e.group, e.index) for e in jm.unit_layout().entries]
    for mode in ("train", "decode"):
        assert tm.layer_costs(4, 64, mode=mode) \
            == jm.layer_costs(4, 64, mode=mode)
    assert tm.kv_position_indexed is False
    assert not getattr(tm, "supports_paged_kv", False)


def test_full_config_param_count():
    """mamba2-780m is 780,148,992 parameters; counted without building
    its weights."""
    full = get_arch("mamba2-780m").make_model()
    n = full.param_count()
    assert 0.7e9 < n < 0.85e9
    assert n == jax_mamba.ARCH.make_model().param_count() == 780_148_992


# -------------------------------------------------------- forward, loss

def test_apply_logits_match(pair):
    jm, jp, tm, tp = pair
    tok = _tokens(1, (2, 21))
    with torch.no_grad():
        ours = tm.apply(tp, torch.from_numpy(tok))
    _close(ours, jm.apply(jp, jnp.asarray(tok)))


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_jax_grad(pair, remat):
    jm, jp, _, _ = pair
    tm = Mamba2LM(dataclasses.replace(mamba2_780m.SMOKE, remat=remat))
    tok = _tokens(2, (2, 19))
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_numpy(jp, "cpu")
    for leaf in _flat(tp).values():
        leaf.requires_grad_(True)
    before = ssd_chunk_grouped.launches
    loss = tm.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert ssd_chunk_grouped.launches == before   # autograd: the einsum path
    _close(loss, jloss, 1e-5)
    ours, theirs = _flat(tp), _flat(jax.device_get(jgrads))
    for k in ours:
        _close(ours[k].grad, theirs[k], TOL)


# ---------------------------------------------------------------- serving

def _prefill_both(pair, tok, max_seq=32):
    jm, jp, tm, tp = pair
    cache = tm.init_cache(tok.shape[0], max_seq, device="cpu")
    with torch.no_grad():
        logits, cache = tm.prefill(tp, torch.from_numpy(tok), cache)
    jlogits, jcache = jm.prefill(jp, jnp.asarray(tok),
                                 jm.init_cache(tok.shape[0], max_seq))
    return (logits, cache), (jlogits, jcache)


def test_prefill_logits_cache_and_decode_match(pair):
    jm, jp, tm, tp = pair
    tok = _tokens(3, (3, 13))                 # 2 chunks of 8, 3 pad steps
    (logits, cache), (jlogits, jcache) = _prefill_both(pair, tok)
    assert isinstance(cache, tuple) and len(cache) == 2
    _close(logits, jlogits)
    for ours, theirs in zip(cache, jcache, strict=True):
        assert tuple(ours.shape) == theirs.shape
        _close(ours, theirs)
    assert cache[0].dtype == torch.float32 and cache[1].dtype == torch.float32
    rng = np.random.default_rng(4)
    for _ in range(4):
        step = rng.integers(0, mamba2_780m.SMOKE.vocab, (3, 1),
                            dtype=np.int32)
        with torch.no_grad():
            logits, out = tm.decode_step(tp, cache, torch.from_numpy(step),
                                         None)
        assert out is cache                    # updated in place
        jlogits, jcache = jm.decode_step(jp, jcache, jnp.asarray(step), None)
        _close(logits, jlogits)
        for ours, theirs in zip(cache, jcache, strict=True):
            _close(ours, theirs)


@pytest.mark.parametrize("n,k", [(5, 4), (16, 3), (2, 3)])
def test_prefill_then_decode_equals_apply(pair, n, k):
    """Prefill of n tokens, then k teacher-forced decode steps, gives the
    logits of a full-sequence apply over n + k (n = 2 is shorter than
    the conv window, which prefill pads with zeros)."""
    _, _, tm, tp = pair
    tok = torch.from_numpy(_tokens(n + k, (2, n + k)))
    with torch.no_grad():
        full = tm.apply(tp, tok)
        cache = tm.init_cache(2, n + k, device="cpu")
        logits, cache = tm.prefill(tp, tok[:, :n], cache)
        got = [logits[:, 0]]
        for i in range(n, n + k - 1):
            logits, cache = tm.decode_step(tp, cache, tok[:, i:i + 1], None)
            got.append(logits[:, 0])
    _close(torch.stack(got, 1), full[:, n - 1:n + k - 1])


def test_prefill_runs_the_kernel_wrapper_once_per_layer(pair, monkeypatch):
    _, _, tm, tp = pair
    import repro_torch.models.mamba2 as mm
    real, calls = mm.ssd_chunk_grouped, []

    def spy(*a, **kw):
        calls.append(tuple(a[0].shape))
        return real(*a, **kw)

    monkeypatch.setattr(mm, "ssd_chunk_grouped", spy)
    before = ssd_chunk_grouped.launches
    with torch.no_grad():
        tm.prefill(tp, torch.from_numpy(_tokens(5, (2, 20))),
                   tm.init_cache(2, 24, device="cpu"))
    cfg = mamba2_780m.SMOKE
    # x in the model's layout, 20 steps padded to 3 chunks of 8
    assert calls == [(2, 3 * cfg.chunk, cfg.n_heads, cfg.head_dim)] \
        * cfg.n_layers
    assert ssd_chunk_grouped.launches == before  # CPU tensors: plain version
