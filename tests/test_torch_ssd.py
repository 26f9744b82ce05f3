"""The port's SSD chunk kernel and chunked SSD against the JAX package's.

On the CPU: the port's plain versions (``ssd_chunk_ref`` in the TPU
layout, ``ssd_chunk_grouped_ref`` in the model's grouped layout) against
the JAX Pallas kernel run in interpret mode and against the JAX ref, on
the same numpy inputs, at ``atol=rtol=2e-5`` (the JAX package's own
sweep tolerance: float32 sums in another order); the grouped plain
version against ``ssd_chunk_ref`` on the TPU layout; the wrappers'
shape, stride and alignment checks and the strides they hand the
kernel; the port's ``ssd_chunked`` (both intra-chunk paths) and
``ssd_decode_step`` against ``repro.models.mamba2`` at ``1e-5``.

On the card (``-m gpu``; skipped without CUDA): the CUDA kernel against
its plain version on the same tensors, through both entries (the
grouped one with b and c as strided views, at the serve geometry and the
smoke widths, one group and several).  Both compute in float32, but
``torch.cumsum`` on the card sums in another order than the kernel's
sequential scan, and ``exp(cum_i - cum_j)`` turns an ulp of ``cum`` into
a relative error of the score, so the bound is relative to the output's
scale: ``|kernel - plain| <= 1e-4 * max|plain|``, plus ``2^-7 * |plain|``
(one bfloat16 ulp) where y is rounded to bfloat16.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ssd_chunk, ssd_chunk_grouped, ssd_chunk_grouped_ref, ssd_chunk_ref)
from repro_torch.kernels.ssd_scan.ops import (  # noqa: E402
    chunk_launch_args, grouped_launch_args, smem_bytes)
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


# ------------------------------------------------------- grouped layout

def _grouped_case(seed, B, L, H, G, cs, p, n, da_scale=1.0):
    """Inputs in the model's layout, L steps zero-padded to a chunk
    multiple as ``ssd_chunked`` pads them (dt = 0 steps: x, b, c and da
    0); the b and c arrays are float32 numpy."""
    rng = np.random.default_rng(seed)
    lp = -(-L // cs) * cs
    x = np.zeros((B, lp, H, p), np.float32)
    b = np.zeros((B, lp, G, n), np.float32)
    c = np.zeros((B, lp, G, n), np.float32)
    da = np.zeros((B, lp, H), np.float32)
    x[:, :L] = rng.standard_normal((B, L, H, p), np.float32)
    b[:, :L] = rng.standard_normal((B, L, G, n), np.float32)
    c[:, :L] = rng.standard_normal((B, L, G, n), np.float32)
    da[:, :L] = -_softplus(rng.standard_normal((B, L, H), np.float32)) \
        * np.float32(da_scale)
    return x, b, c, da


def _to_tpu_layout(x, b, c, da, cs):
    """numpy: the grouped case expanded to one group per head and cut
    into chunks, [B, NC, H, cs, .]."""
    B, lp, H, p = x.shape
    rep = H // b.shape[2]
    nc = lp // cs

    def cut(t):
        return np.ascontiguousarray(
            t.reshape(B, nc, cs, *t.shape[2:]).swapaxes(2, 3))

    return (cut(x), cut(np.repeat(b, rep, axis=2)),
            cut(np.repeat(c, rep, axis=2)), cut(da[..., None])[..., 0])


# (B, L, H, G, cs, p, n): G = 1 (mamba2-780m's), G = 2, G = H; L not a
# multiple of cs (a padded tail) in every case
GROUPED = [(2, 29, 4, 1, 8, 8, 16), (1, 40, 6, 2, 16, 4, 8),
           (2, 20, 4, 4, 8, 8, 8), (1, 70, 8, 1, 32, 16, 16)]


@pytest.mark.parametrize("B,L,H,G,cs,p,n", GROUPED)
@pytest.mark.parametrize("bc", ["float32", "bfloat16"])
def test_ssd_grouped_ref_matches_jax_kernel(B, L, H, G, cs, p, n, bc):
    """The grouped plain version against the JAX Pallas kernel (interpret
    mode) on the expanded inputs, b and c in float32 and in bfloat16."""
    jax, jnp = _jax()
    from repro.kernels.ssd_scan import ssd_chunk as jax_kernel
    x, b, c, da = _grouped_case(L + G, B, L, H, G, cs, p, n)
    bdt = getattr(torch, bc)
    y, s = ssd_chunk_grouped_ref(_t(x), _t(b, bdt), _t(c, bdt), _t(da), cs)
    assert y.shape == x.shape and y.dtype == torch.float32
    assert s.shape == (B, x.shape[1] // cs, H, p, n)
    xt, bt, ct, dat = _to_tpu_layout(x, b, c, da, cs)
    jdt = getattr(jnp, bc)
    yj, sj = jax_kernel(jnp.asarray(xt), jnp.asarray(bt, jdt),
                        jnp.asarray(ct, jdt), jnp.asarray(dat))
    _close(y.reshape(B, -1, cs, H, p).transpose(2, 3),
           np.asarray(yj, np.float32), 2e-5)
    _close(s, sj, 2e-5)


@pytest.mark.parametrize("B,L,H,G,cs,p,n", GROUPED)
def test_ssd_grouped_ref_equals_chunk_ref_on_the_tpu_layout(B, L, H, G, cs,
                                                            p, n):
    """Expanding the groups and cutting the chunks, then the TPU-layout
    plain version, is the grouped plain version: the same arithmetic,
    bit for bit."""
    x, b, c, da = _grouped_case(3 * L, B, L, H, G, cs, p, n, da_scale=40.0)
    y, s = ssd_chunk_grouped_ref(_t(x), _t(b), _t(c), _t(da), cs)
    yt, st = ssd_chunk_ref(*(_t(a) for a in _to_tpu_layout(x, b, c, da,
                                                           cs)))
    torch.testing.assert_close(y.reshape(B, -1, cs, H, p).transpose(2, 3),
                               yt, rtol=0, atol=0)
    torch.testing.assert_close(s, st, rtol=0, atol=0)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()


def test_grouped_cpu_tensors_take_the_plain_version():
    x, b, c, da = (_t(a) for a in _grouped_case(2, 2, 20, 4, 2, 8, 8, 16))
    before = ssd_chunk_grouped.launches
    got = ssd_chunk_grouped(x, b, c, da, 8)
    want = ssd_chunk_grouped_ref(x, b, c, da, 8)
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert ssd_chunk_grouped.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunk_grouped(x, b, c, da, 8, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ssd_chunk_grouped(x, b, c, da, 8, impl="pallas")
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_chunk_grouped(x.requires_grad_(), b, c, da, 8)


def _conv_views(B, L, H, p, G, n, dtype=torch.bfloat16):
    """x * dt as the model makes it (contiguous float32) and b, c as the
    model's views: slices of one [B, L, H p + 2 G n] conv output."""
    conv = torch.randn(B, L, H * p + 2 * G * n).to(dtype)
    b = conv[..., H * p:H * p + G * n].reshape(B, L, G, n)
    c = conv[..., H * p + G * n:].reshape(B, L, G, n)
    return torch.randn(B, L, H, p), b, c, -torch.rand(B, L, H)


def test_grouped_launch_args_read_the_model_views_by_stride():
    """mamba2-780m's prefill group: b and c stay views of the conv output
    (row stride 3328), x and da contiguous; the kernel gets their strides
    as (batch, chunk, row, group or head), y's of a contiguous [B, Lp,
    H, p]."""
    B, L, H, p, G, n, cs = 2, 512, 48, 64, 1, 128, 128
    x, b, c, da = _conv_views(B, L, H, p, G, n)
    assert not b.is_contiguous()
    dims, strides = grouped_launch_args(x, b, c, da, cs)
    row = H * p + 2 * G * n
    assert dims == (B, L // cs, H, G, cs, p, n)
    assert strides == ((L * H * p, cs * H * p, H * p, p)
                       + (L * row, cs * row, row, n)
                       + (L * row, cs * row, row, n)
                       + (L * H, cs * H, H, 1)
                       + (L * H * p, cs * H * p, H * p, p))


def test_chunk_launch_args_on_the_tpu_layout():
    """The TPU layout is the same kernel with G = H and other strides."""
    B, NC, H, cs, p, n = 2, 3, 4, 16, 8, 16
    x, b = torch.zeros(B, NC, H, cs, p), torch.zeros(B, NC, H, cs, n)
    dims, strides = chunk_launch_args(x, b, b, torch.zeros(B, NC, H, cs))
    assert dims == (B, NC, H, H, cs, p, n)
    xs, bs = (NC * H * cs * p, H * cs * p, p, cs * p), \
        (NC * H * cs * n, H * cs * n, n, cs * n)
    assert strides == xs + bs + bs + (NC * H * cs, H * cs, 1, cs) + xs


def test_grouped_launch_args_refuse_what_the_kernel_does_not_take():
    x, b, c, da = _conv_views(1, 32, 4, 8, 2, 16)
    grouped_launch_args(x, b, c, da, 16)
    with pytest.raises(TypeError, match="float32 x"):
        grouped_launch_args(x.bfloat16(), b, c, da, 16)
    with pytest.raises(TypeError, match="both"):
        grouped_launch_args(x, b, c.float(), da, 16)
    with pytest.raises(TypeError, match="da"):
        grouped_launch_args(x, b, c, da.double(), 16)
    with pytest.raises(ValueError, match="shapes"):
        grouped_launch_args(x[0], b, c, da, 16)
    with pytest.raises(ValueError, match="disagree"):
        grouped_launch_args(x, b[:, :16], c[:, :16], da, 16)
    with pytest.raises(ValueError, match="not a multiple of G"):
        grouped_launch_args(x[:, :, :3], b, c, da[..., :3], 16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        grouped_launch_args(x, b, c, da, 12)
    with pytest.raises(ValueError, match="p <="):
        grouped_launch_args(torch.zeros(1, 32, 4, 256), b, c, da, 16)
    with pytest.raises(ValueError, match="multiple of 4"):
        grouped_launch_args(torch.zeros(1, 32, 4, 6), b, c, da, 16)
    with pytest.raises(ValueError, match="of 8"):         # bfloat16 rows
        grouped_launch_args(x, b[..., :12], c[..., :12], da, 16)
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros(1, 256, 4, 128)
        bb = torch.zeros(1, 256, 2, 256)
        grouped_launch_args(big, bb, bb, torch.zeros(1, 256, 4), 256)
    with pytest.raises(ValueError, match="last dimension"):
        grouped_launch_args(torch.zeros(1, 32, 8, 4).transpose(2, 3), b, c,
                            da, 16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        odd = torch.zeros(1 * 32 * 4 * 8 + 1)[1:].reshape(1, 32, 4, 8)
        grouped_launch_args(odd, b, c, da, 16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        conv = torch.zeros(1, 32, 2 * 16 * 2 + 4, dtype=torch.bfloat16)
        bv = conv[..., :32].reshape(1, 32, 2, 16)    # rows of 68 bytes
        grouped_launch_args(x, bv, bv, da, 16)


def test_smem_bytes_of_the_serve_geometry():
    """Two blocks an SM at the serve geometry (bfloat16 b and c): 105,472
    bytes a block, the figure of the source's header."""
    assert smem_bytes(128, 64, 128, torch.bfloat16) == 105_472
    assert 2 * (smem_bytes(128, 64, 128, torch.bfloat16) + 1024) \
        <= 228 * 1024


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

    @pytest.mark.parametrize("B,L,H,G,cs,p,n", [
        (2, 480, 48, 1, 128, 64, 128),  # the serve group: 2 x 480 -> 512
        (2, 20, 12, 1, 8, 8, 16),       # mamba2 smoke widths, G 1
        (2, 20, 12, 3, 8, 8, 16),       # smoke widths, G 3
        (1, 300, 8, 2, 128, 16, 32),    # G 2, a padded tail
        (2, 100, 6, 6, 32, 24, 40),     # G = H, ragged widths
        (1, 100, 4, 2, 48, 8, 16),      # 3 row tiles: a middle tile alone
        (1, 600, 4, 2, 256, 32, 64),    # cs 256: 16 warps
    ])
    @pytest.mark.parametrize("bt", [torch.float32, torch.bfloat16])
    def test_grouped_kernel_matches_ref(self, cuda, B, L, H, G, cs, p, n,
                                        bt):
        """b and c as the model hands them: views of one conv output."""
        x, b, c, da = _grouped_case(L + H + G, B, L, H, G, cs, p, n)
        lp = x.shape[1]
        conv = _t(np.concatenate([b.reshape(B, lp, G * n),
                                  c.reshape(B, lp, G * n)], -1), bt, cuda)
        bv = conv[..., :G * n].reshape(B, lp, G, n)
        cv = conv[..., G * n:].reshape(B, lp, G, n)
        args = (_t(x, device=cuda), bv, cv, _t(da, device=cuda))
        before = ssd_chunk_grouped.launches
        y, s = ssd_chunk_grouped(*args, cs)
        torch.cuda.synchronize()
        assert ssd_chunk_grouped.launches == before + 1
        assert y.shape == x.shape and y.dtype == s.dtype == torch.float32
        yr, sr = ssd_chunk_grouped(*args, cs, impl="ref")
        _kernel_close(y, yr)
        _kernel_close(s, sr)

    def test_grouped_and_tpu_layout_agree(self, cuda):
        """One function, two layouts: the grouped call and the TPU-layout
        call of the same cells give the same y and states."""
        x, b, c, da = _grouped_case(8, 2, 250, 8, 2, 128, 64, 128)
        g = (_t(x, device=cuda), _t(b, torch.bfloat16, cuda),
             _t(c, torch.bfloat16, cuda), _t(da, device=cuda))
        t = tuple(_t(a, dt, cuda) for a, dt in zip(
            _to_tpu_layout(x, b, c, da, 128),
            (torch.float32, torch.bfloat16, torch.bfloat16, torch.float32),
            strict=True))
        yg, sg = ssd_chunk_grouped(*g, 128)
        yt, st = ssd_chunk(*t)
        torch.cuda.synchronize()
        torch.testing.assert_close(yg.reshape(2, 2, 128, 8, 64).transpose(
            2, 3), yt, rtol=0, atol=0)
        torch.testing.assert_close(sg, st, rtol=0, atol=0)

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
