"""The port's SSD chunk kernel and chunked SSD against the JAX package's.

On the CPU: the port's plain version (``ssd_chunk_ref``) against the JAX
Pallas kernel run in interpret mode and against the JAX ref, on the same
numpy inputs, at ``atol=rtol=2e-5`` (the JAX package's own sweep
tolerance: float32 sums in another order); the port's ``ssd_chunked``
(both intra-chunk paths) and ``ssd_decode_step`` against
``repro.models.mamba2`` at ``1e-5``.

On the card (``-m gpu``; skipped without CUDA): the CUDA kernel against
its plain version on the same tensors.  Both compute in float32, but
``torch.cumsum`` on the card sums in another order than the kernel's
sequential scan, and ``exp(cum_i - cum_j)`` turns an ulp of ``cum`` into
a relative error of the score, so the bound is relative to the output's
scale: ``|kernel - plain| <= 1e-4 * max|plain|``, plus ``2^-7 * |plain|``
(one bfloat16 ulp) where y is rounded to bfloat16.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_ref  # noqa: E402
from repro_torch.models.mamba2 import (ssd_chunked,  # noqa: E402
                                       ssd_decode_step)

torch.set_num_threads(1)

# the shapes of the JAX package's kernel sweep (tests/test_kernels.py)
SWEEP = [(1, 2, 2, 8, 8, 8), (2, 3, 4, 16, 8, 16), (1, 1, 8, 32, 16, 8)]


def _jax():
    jax = pytest.importorskip("jax")
    return jax, jax.numpy


def _softplus(z):
    return np.logaddexp(z, 0.0).astype(np.float32)


def _chunk_case(seed, B, NC, H, cs, p, n, da_scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, NC, H, cs, p), np.float32)
    b = rng.standard_normal((B, NC, H, cs, n), np.float32)
    c = rng.standard_normal((B, NC, H, cs, n), np.float32)
    da = -_softplus(rng.standard_normal((B, NC, H, cs), np.float32)) \
        * np.float32(da_scale)
    return x, b, c, da


def _t(a, dtype=torch.float32, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=dtype)


def _close(a, b, tol):
    a = a.detach().float().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)
    np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------- kernel

@pytest.mark.parametrize("B,NC,H,cs,p,n", SWEEP)
def test_ssd_chunk_ref_matches_jax(B, NC, H, cs, p, n):
    jax, jnp = _jax()
    from repro.kernels.ssd_scan import ssd_chunk as jax_kernel
    from repro.kernels.ssd_scan import ssd_chunk_ref as jax_ref
    x, b, c, da = _chunk_case(B * NC * H, B, NC, H, cs, p, n)
    y, s = ssd_chunk_ref(_t(x), _t(b), _t(c), _t(da))
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    for fn in (jax_kernel, jax_ref):
        yj, sj = fn(*(jnp.asarray(a) for a in (x, b, c, da)))
        _close(y, yj, 2e-5)
        _close(s, sj, 2e-5)


def test_ssd_chunk_ref_takes_bf16_operands_like_jax():
    """The full-width prefill's types: x float32, b and c bfloat16 (cast
    to float32 on load), y in x's type."""
    jax, jnp = _jax()
    from repro.kernels.ssd_scan import ssd_chunk as jax_kernel
    x, b, c, da = _chunk_case(5, 1, 2, 4, 16, 8, 16)
    bb, cb = (jnp.asarray(a, jnp.bfloat16) for a in (b, c))
    yj, sj = jax_kernel(jnp.asarray(x), bb, cb, jnp.asarray(da))
    y, s = ssd_chunk_ref(_t(x), _t(b, torch.bfloat16), _t(c, torch.bfloat16),
                         _t(da))
    assert y.dtype == torch.float32
    _close(y, yj, 2e-5)
    _close(s, sj, 2e-5)
    yb, _ = ssd_chunk_ref(_t(x, torch.bfloat16), _t(b, torch.bfloat16),
                          _t(c, torch.bfloat16), _t(da))
    assert yb.dtype == torch.bfloat16


def test_ssd_chunk_selects_above_the_diagonal():
    """A steep decay overflows exp(cum_i - cum_j) above the diagonal; the
    mask selects 0 there, so nothing turns into NaN."""
    x, b, c, da = _chunk_case(3, 1, 1, 2, 32, 8, 8, da_scale=200.0)
    y, s = ssd_chunk_ref(_t(x), _t(b), _t(c), _t(da))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()


def test_cpu_tensors_take_the_plain_version_and_cuda_impl_raises():
    x, b, c, da = (_t(a) for a in _chunk_case(1, 1, 2, 2, 8, 8, 8))
    before = ssd_chunk.launches
    got = ssd_chunk(x, b, c, da)
    want = ssd_chunk_ref(x, b, c, da)
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert ssd_chunk.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunk(x, b, c, da, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ssd_chunk(x, b, c, da, impl="pallas")
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_chunk(x.requires_grad_(), b, c, da)
    with torch.no_grad():
        ssd_chunk(x, b, c, da)


# --------------------------------------------------------- chunked SSD

def _ssd_case(seed, B, L, H, P, G, N, init):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P), np.float32)
    dt = _softplus(rng.standard_normal((B, L, H), np.float32))
    a_log = np.log(np.linspace(1.0, 4.0, H, dtype=np.float32))
    b = rng.standard_normal((B, L, G, N), np.float32)
    c = rng.standard_normal((B, L, G, N), np.float32)
    s0 = rng.standard_normal((B, H, P, N), np.float32) if init else None
    return x, dt, a_log, b, c, s0


@pytest.mark.parametrize("B,L,H,P,G,N,chunk,init", [
    (2, 29, 4, 8, 1, 16, 8, False),     # 4 chunks, 3 dt = 0 pad steps
    (1, 40, 6, 4, 2, 8, 8, True),       # n_groups 2, an initial state
    (2, 16, 4, 8, 4, 8, 16, True),      # one chunk, one group per head
    (1, 5, 2, 8, 1, 16, 8, False),      # shorter than one chunk
])
@pytest.mark.parametrize("impl", ["ref", "einsum"])
def test_ssd_chunked_matches_jax(B, L, H, P, G, N, chunk, init, impl):
    jax, jnp = _jax()
    from repro.models.mamba2 import ssd_chunked as jax_ssd
    case = _ssd_case(L + G, B, L, H, P, G, N, init)
    yj, fj = jax_ssd(*(jnp.asarray(a) for a in case[:5]), chunk,
                     None if case[5] is None else jnp.asarray(case[5]))
    with torch.no_grad():
        y, f = ssd_chunked(*(_t(a) for a in case[:5]), chunk,
                           None if case[5] is None else _t(case[5]),
                           impl=impl)
    assert y.shape == (B, L, H, P) and f.shape == (B, H, P, N)
    _close(y, yj, 1e-5)
    _close(f, fj, 1e-5)


def test_ssd_chunked_takes_the_einsum_path_under_autograd():
    case = [_t(a) for a in _ssd_case(4, 1, 12, 2, 4, 1, 8, False)[:5]]
    x = case[0].requires_grad_()
    before = ssd_chunk.launches
    y, _ = ssd_chunked(x, *case[1:], 8)
    y.sum().backward()
    assert x.grad is not None and ssd_chunk.launches == before
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_chunked(x, *case[1:], 8, impl="ref")


def test_ssd_decode_step_matches_jax():
    jax, jnp = _jax()
    from repro.models.mamba2 import ssd_decode_step as jax_step
    rng = np.random.default_rng(9)
    B, H, P, G, N = 3, 6, 4, 2, 8
    x = rng.standard_normal((B, H, P), np.float32)
    dt = _softplus(rng.standard_normal((B, H), np.float32))
    a_log = np.log(np.linspace(1.0, 16.0, H, dtype=np.float32))
    b = rng.standard_normal((B, G, N), np.float32)
    c = rng.standard_normal((B, G, N), np.float32)
    s = rng.standard_normal((B, H, P, N), np.float32)
    args = (x, dt, a_log, b, c, s)
    yj, sj = jax_step(*(jnp.asarray(a) for a in args))
    y, s2 = ssd_decode_step(*(_t(a) for a in args))
    _close(y, yj, 1e-5)
    _close(s2, sj, 1e-5)


def test_ssd_chunk_matches_model_oracle():
    """Kernel contract's intra-chunk part == the model-level chunked SSD
    with a single chunk and a zero initial state (mirror of the JAX
    package's test), for the port's and the JAX package's oracle."""
    jax, jnp = _jax()
    from repro.models.mamba2 import ssd_chunked as jax_ssd
    B, H, cs, p, n = 2, 4, 16, 8, 16
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, cs, H, p), np.float32)
    dt = _softplus(rng.standard_normal((B, cs, H), np.float32))
    a_log = np.log(np.linspace(1.0, 4.0, H, dtype=np.float32))
    bmat = rng.standard_normal((B, cs, 1, n), np.float32)
    cmat = rng.standard_normal((B, cs, 1, n), np.float32)
    with torch.no_grad():
        y_full, state = ssd_chunked(_t(x), _t(dt), _t(a_log), _t(bmat),
                                    _t(cmat), cs, impl="einsum")
    yj, sj = jax_ssd(*(jnp.asarray(a) for a in (x, dt, a_log, bmat, cmat)),
                     cs)

    tx, tdt, ta = _t(x), _t(dt), _t(a_log)
    xdt = (tx * tdt[..., None]).reshape(B, 1, cs, H, p).transpose(2, 3)
    da = (tdt * -torch.exp(ta)).reshape(B, 1, cs, H).transpose(2, 3)
    bq = _t(bmat).repeat_interleave(H, 2).reshape(B, 1, cs, H, n) \
        .transpose(2, 3)
    cq = _t(cmat).repeat_interleave(H, 2).reshape(B, 1, cs, H, n) \
        .transpose(2, 3)
    y_k, s_k = ssd_chunk(*(t.contiguous() for t in (xdt, bq, cq, da)))
    for want_y, want_s in ((y_full, state), (yj, sj)):
        _close(y_k[:, 0].transpose(1, 2), want_y, 1e-4)
        _close(s_k[:, 0], want_s, 1e-4)


# ------------------------------------------------------------ on the card

_REL = 1e-4          # of max|plain|: the cumsum order (module docstring)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel-vs-ref runs on the card)")
    return torch.device("cuda")


def _kernel_close(got, want):
    got, want = got.float(), want.float()
    limit = _REL * want.abs().max()
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= limit).all(), \
        (got - want).abs().max().item()


@pytest.mark.gpu
class TestCudaKernel:
    @pytest.mark.parametrize("shape", SWEEP + [
        (1, 1, 6, 8, 8, 16),           # mamba2 smoke: cs 8, p 8, n 16
        (2, 4, 48, 128, 64, 128),      # mamba2-780m prefill, 2 x 512
        (1, 3, 5, 100, 24, 40),        # ragged widths, a partial tile
    ])
    @pytest.mark.parametrize("bt", [torch.float32, torch.bfloat16])
    def test_kernel_matches_ref(self, cuda, shape, bt):
        x, b, c, da = _chunk_case(sum(shape), *shape)
        args = (_t(x, device=cuda), _t(b, bt, cuda), _t(c, bt, cuda),
                _t(da, device=cuda))
        before = ssd_chunk.launches
        y, s = ssd_chunk(*args)
        torch.cuda.synchronize()
        assert ssd_chunk.launches == before + 1
        assert y.dtype == s.dtype == torch.float32
        yr, sr = ssd_chunk(*args, impl="ref")
        _kernel_close(y, yr)
        _kernel_close(s, sr)

    def test_kernel_selects_above_the_diagonal(self, cuda):
        x, b, c, da = _chunk_case(3, 1, 2, 4, 128, 64, 128, da_scale=200.0)
        y, s = ssd_chunk(*(_t(a, device=cuda) for a in (x, b, c, da)))
        torch.cuda.synchronize()
        assert torch.isfinite(y).all() and torch.isfinite(s).all()
        yr, sr = ssd_chunk_ref(*(_t(a, device=cuda) for a in (x, b, c, da)))
        _kernel_close(y, yr)
        _kernel_close(s, sr)

    def test_model_prefill_path_matches_ref(self, cuda):
        case = _ssd_case(11, 2, 300, 8, 16, 1, 32, True)
        args = [_t(a, device=cuda) for a in case[:5]]
        with torch.no_grad():
            y, f = ssd_chunked(*args, 128, _t(case[5], device=cuda),
                               impl="cuda")
            yr, fr = ssd_chunked(*args, 128, _t(case[5], device=cuda),
                                 impl="ref")
        _kernel_close(y, yr)
        _kernel_close(f, fr)

    def test_wrapper_rejects_what_the_kernel_does_not_take(self, cuda):
        x, b, c, da = (_t(a, device=cuda)
                       for a in _chunk_case(1, 1, 2, 2, 8, 8, 8))
        with pytest.raises(RuntimeError, match="no backward"):
            ssd_chunk(x.clone().requires_grad_(), b, c, da)
        with pytest.raises(TypeError):
            ssd_chunk(x.half(), b, c, da)
        with pytest.raises(TypeError, match="float32 x"):
            ssd_chunk(x.bfloat16(), b, c, da)
        with pytest.raises(TypeError):
            ssd_chunk(x, b, c.bfloat16(), da)
        with pytest.raises(TypeError):
            ssd_chunk(x, b, c, da.double())
        with pytest.raises(ValueError, match="shapes"):
            ssd_chunk(x[0], b, c, da)
        with pytest.raises(ValueError, match="disagree"):
            ssd_chunk(x, b[:, :1], c[:, :1], da)
        with pytest.raises(ValueError, match="contiguous"):
            ssd_chunk(x.transpose(3, 4).contiguous().transpose(3, 4), b, c,
                      da)
        with pytest.raises(ValueError, match="p <="):
            big = torch.zeros(1, 1, 1, 8, 256, device=cuda)
            ssd_chunk(big, b[:1, :1, :1], c[:1, :1, :1], da[:1, :1, :1])
        with pytest.raises(ValueError, match="shared memory"):
            xs = torch.zeros(1, 1, 1, 256, 128, device=cuda)
            bs = torch.zeros(1, 1, 1, 256, 256, device=cuda)
            ssd_chunk(xs, bs, bs, torch.zeros(1, 1, 1, 256, device=cuda))
