"""The port's attention kernels against the JAX package's.

On the CPU: the port's plain versions (``ref.py``) against the JAX
Pallas kernels run in interpret mode and against the JAX refs, on the
same numpy inputs.  Tolerance: float32 ``atol=rtol=1e-5`` (the two
frameworks sum in different orders); bfloat16 is compared after casting
both sides to float32 with ``atol=rtol=1e-2`` (bfloat16 rounds the
probabilities and the output).

On the card (``-m gpu``; skipped without CUDA): each CUDA kernel against
its plain version on the same tensors, float32 ``2e-5`` and bfloat16
``2e-2`` (the kernel keeps probabilities in float32 where the plain
version rounds them to bfloat16).  Run there with
``python -m pytest --noconftest -q -m gpu tests/test_torch_*.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref, flash_attention)
from repro_torch.kernels.paged_attention import (  # noqa: E402
    gather_pages, paged_attention, write_token_to_pages)

torch.set_num_threads(1)

_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _jax():
    jax = pytest.importorskip("jax")
    return jax, jax.numpy


def _to_jax(x, dtype):
    _, jnp = _jax()
    return jnp.asarray(x, getattr(jnp, dtype))


def _to_torch(x, dtype, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        device=device, dtype=getattr(torch, dtype))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_f32(a), _f32(b), rtol=tol, atol=tol)


def _paged_case(seed, slots, nq, nkv, hd, ps, mb):
    """Random page pool, disjoint per-slot block tables and ragged
    lengths (one page-boundary slot, one full-stream slot); entries past
    a slot's allocated blocks point at trash page 0."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + slots * mb
    q = rng.standard_normal((slots, nq, hd), np.float32)
    kp = rng.standard_normal((n_pages, ps, nkv, hd), np.float32)
    vp = rng.standard_normal((n_pages, ps, nkv, hd), np.float32)
    bt = rng.permutation(np.arange(1, n_pages)).reshape(slots, mb)
    kv_len = rng.integers(1, mb * ps + 1, size=slots)
    kv_len[0] = ps
    kv_len[-1] = mb * ps
    for s in range(slots):
        bt[s, -(-int(kv_len[s]) // ps):] = 0
    return q, kp, vp, bt.astype(np.int32), kv_len.astype(np.int32)


def _paged_both(case, dtype, device="cpu"):
    q, kp, vp, bt, kv_len = case
    t = (_to_torch(q, dtype, device), _to_torch(kp, dtype, device),
         _to_torch(vp, dtype, device), torch.from_numpy(bt).to(device),
         torch.from_numpy(kv_len).to(device))
    return t


# GQA groups 1 / 2 / 4 over page sizes 16 / 8 / 4, then groups 3 / 5 / 7
# (qwen3's and phi4-mini's 3, qwen2.5-32b's 5, llava's 7: the score loop's
# rows of 4 with a partial last pass) over pages of 16 / 8 / 4
PAGED_SWEEP = [
    (3, 4, 2, 32, 8, 4),
    (2, 4, 4, 16, 16, 2),
    (4, 8, 2, 8, 4, 8),
    (3, 6, 2, 32, 16, 4),
    (2, 10, 2, 16, 8, 3),
    (4, 14, 2, 8, 4, 8),
]


# ---------------------------------------------------------------------------
# paged attention: port ref vs JAX (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slots,nq,nkv,hd,ps,mb", PAGED_SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_ref_matches_jax(slots, nq, nkv, hd, ps, mb, dtype):
    from repro.kernels.paged_attention import paged_attention as jax_paged
    case = _paged_case(slots * nq + ps, slots, nq, nkv, hd, ps, mb)
    q, kp, vp, bt, kv_len = case
    jargs = (_to_jax(q, dtype), _to_jax(kp, dtype), _to_jax(vp, dtype),
             _to_jax(bt, "int32"), _to_jax(kv_len, "int32"))
    got = paged_attention(*_paged_both(case, dtype))
    assert got.dtype == getattr(torch, dtype)
    for impl in ("interpret", "ref"):
        _close(got, jax_paged(*jargs, impl=impl), _TOL[dtype])


def test_paged_ref_matches_jax_windowed():
    from repro.kernels.paged_attention import paged_attention as jax_paged
    case = _paged_case(7, 3, 4, 2, 16, 8, 4)
    jargs = [_to_jax(a, "int32" if a.dtype == np.int32 else "float32")
             for a in case]
    got = paged_attention(*_paged_both(case, "float32"), window=5)
    for impl in ("interpret", "ref"):
        _close(got, jax_paged(*jargs, window=5, impl=impl), 1e-5)


def test_paged_trash_page_contents_never_leak():
    """Poisoning the trash page with huge values changes nothing: the
    mask is applied before the softmax."""
    from repro.kernels.paged_attention import paged_attention as jax_paged
    q, kp, vp, bt, kv_len = _paged_case(13, 3, 4, 2, 16, 8, 4)
    base = paged_attention(*_paged_both((q, kp, vp, bt, kv_len), "float32"))
    kp[0], vp[0] = 1e4, 1e4
    poisoned = (q, kp, vp, bt, kv_len)
    out = paged_attention(*_paged_both(poisoned, "float32"))
    np.testing.assert_array_equal(_f32(base), _f32(out))
    jout = jax_paged(*[_to_jax(a, "int32" if a.dtype == np.int32
                               else "float32") for a in poisoned],
                     impl="interpret")
    _close(out, jout, 1e-5)


def test_write_token_and_gather_pages_match_jax():
    from repro.kernels.paged_attention import gather_pages as jax_gather
    from repro.kernels.paged_attention import \
        write_token_to_pages as jax_write
    rng = np.random.default_rng(3)
    slots, ps, mb, nkv, hd = 4, 4, 3, 2, 8
    n_pages = 1 + slots * mb
    pages = rng.standard_normal((n_pages, ps, nkv, hd), np.float32)
    bt = (1 + np.arange(slots * mb)).reshape(slots, mb).astype(np.int32)
    pos = np.array([0, 5, 11, 7], np.int32)
    active = np.array([True, False, True, False])
    vals = rng.standard_normal((slots, nkv, hd), np.float32)

    got = write_token_to_pages(torch.from_numpy(pages.copy()),
                               torch.from_numpy(bt), torch.from_numpy(pos),
                               torch.from_numpy(active),
                               torch.from_numpy(vals))
    want = jax_write(_to_jax(pages, "float32"), _to_jax(bt, "int32"),
                     _to_jax(pos, "int32"), _to_jax(active, "bool"),
                     _to_jax(vals, "float32"))
    # several inactive lanes may hit trash page 0 at once (either write
    # may win, and page 0 is never read); every other page is exact
    np.testing.assert_array_equal(_f32(got)[1:], np.asarray(want)[1:])
    # the block tables reference no trash page, so the gathered streams
    # are exact
    np.testing.assert_array_equal(
        _f32(gather_pages(got, torch.from_numpy(bt))),
        np.asarray(jax_gather(want, _to_jax(bt, "int32"))))


# ---------------------------------------------------------------------------
# flash attention: port ref vs JAX (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,sq,sk,nq,nkv,hd,causal,dtype", [
    (2, 100, 100, 4, 2, 16, True, "float32"),     # sq not a multiple of 64
    (1, 72, 72, 4, 1, 8, True, "bfloat16"),
    (1, 72, 40, 2, 2, 16, False, "float32"),      # non-causal, sk != sq
])
def test_flash_ref_matches_jax_kernel(b, sq, sk, nq, nkv, hd, causal, dtype):
    from repro.kernels.flash_attention.kernel import flash_attention_fwd
    rng = np.random.default_rng(sq + nq)
    q = rng.standard_normal((b, sq, nq, hd), np.float32)
    k = rng.standard_normal((b, sk, nkv, hd), np.float32)
    v = rng.standard_normal((b, sk, nkv, hd), np.float32)
    got = flash_attention(_to_torch(q, dtype), _to_torch(k, dtype),
                          _to_torch(v, dtype), causal=causal)
    want = flash_attention_fwd(_to_jax(q, dtype), _to_jax(k, dtype),
                               _to_jax(v, dtype), causal=causal,
                               block_q=64, block_k=64, interpret=True)
    assert got.shape == (b, sq, nq, hd)
    _close(got, want, _TOL[dtype])


@pytest.mark.parametrize("window", [1, 7, 70])
def test_flash_ref_windowed_matches_jax_attention(window):
    """The JAX flash kernel has no window; windowed prefill in the
    reference is ``gqa_attention(causal=True, window=...)``."""
    from repro.models.layers import gqa_attention as jax_gqa
    rng = np.random.default_rng(window)
    b, s, nq, nkv, hd = 2, 100, 4, 2, 16
    q = rng.standard_normal((b, s, nq, hd), np.float32)
    k = rng.standard_normal((b, s, nkv, hd), np.float32)
    v = rng.standard_normal((b, s, nkv, hd), np.float32)
    got = flash_attention(_to_torch(q, "float32"), _to_torch(k, "float32"),
                          _to_torch(v, "float32"), causal=True, window=window)
    want = jax_gqa(_to_jax(q, "float32"), _to_jax(k, "float32"),
                   _to_jax(v, "float32"), causal=True, window=window)
    _close(got, want, _TOL["float32"])


def test_cpu_tensors_take_the_plain_version_and_cuda_impl_raises():
    q = torch.zeros(1, 4, 2, 8)
    before = flash_attention.launches
    torch.testing.assert_close(flash_attention(q, q, q),
                               attention_ref(q, q, q))
    assert flash_attention.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q, impl="cuda")
    case = _paged_both(_paged_case(1, 2, 4, 2, 8, 4, 2), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention(*case, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        paged_attention(*case, impl="pallas")


# ---------------------------------------------------------------------------
# CUDA kernels vs their plain versions (on the card only)
# ---------------------------------------------------------------------------

_KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel-vs-ref runs on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
class TestCudaKernels:
    @pytest.mark.parametrize("slots,nq,nkv,hd,ps,mb", PAGED_SWEEP + [
        (8, 32, 8, 64, 16, 64),        # granite-3-2b decode, 1024 deep
        (8, 56, 8, 128, 16, 70),       # llava-next-34b decode, g 7
    ])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_paged_kernel_matches_ref(self, cuda, slots, nq, nkv, hd, ps,
                                      mb, dtype):
        args = _paged_both(_paged_case(slots + hd, slots, nq, nkv, hd, ps,
                                       mb), dtype, cuda)
        before = paged_attention.launches
        got = paged_attention(*args)
        torch.cuda.synchronize()
        assert paged_attention.launches == before + 1
        _close(got, paged_attention(*args, impl="ref"), _KERNEL_TOL[dtype])

    @pytest.mark.parametrize("window", [1, 5, 40])
    def test_paged_kernel_windowed(self, cuda, window):
        args = _paged_both(_paged_case(7, 3, 4, 2, 16, 8, 4), "float32",
                           cuda)
        _close(paged_attention(*args, window=window),
               paged_attention(*args, window=window, impl="ref"), 2e-5)

    def test_paged_kernel_ignores_trash_page(self, cuda):
        q, kp, vp, bt, kv_len = _paged_case(13, 3, 4, 2, 16, 8, 4)
        base = paged_attention(*_paged_both((q, kp, vp, bt, kv_len),
                                            "float32", cuda))
        kp[0], vp[0] = 1e4, 1e4
        out = paged_attention(*_paged_both((q, kp, vp, bt, kv_len),
                                           "float32", cuda))
        torch.testing.assert_close(out, base, rtol=0, atol=0)

    @pytest.mark.parametrize("b,sq,sk,nq,nkv,hd,causal", [
        (2, 100, 100, 4, 2, 16, True),
        (1, 72, 72, 4, 1, 8, True),
        (1, 72, 40, 2, 2, 32, False),
        (2, 130, 130, 8, 8, 128, True),
        (4, 512, 512, 32, 8, 64, True),     # granite-3-2b prefill
    ])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_flash_kernel_matches_ref(self, cuda, b, sq, sk, nq, nkv, hd,
                                      causal, dtype):
        rng = np.random.default_rng(sq + hd)
        q, k, v = (_to_torch(rng.standard_normal(shape, np.float32), dtype,
                             cuda)
                   for shape in ((b, sq, nq, hd), (b, sk, nkv, hd),
                                 (b, sk, nkv, hd)))
        before = flash_attention.launches
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        _close(got, flash_attention(q, k, v, causal=causal, impl="ref"),
               _KERNEL_TOL[dtype])

    @pytest.mark.parametrize("window", [1, 5, 64, 100, 1000])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_flash_kernel_windowed(self, cuda, window, dtype):
        rng = np.random.default_rng(window)
        q, k, v = (_to_torch(rng.standard_normal(shape, np.float32), dtype,
                             cuda)
                   for shape in ((2, 200, 8, 64), (2, 200, 2, 64),
                                 (2, 200, 2, 64)))
        _close(flash_attention(q, k, v, window=window),
               flash_attention(q, k, v, window=window, impl="ref"),
               _KERNEL_TOL[dtype])

    def test_wrappers_reject_what_the_kernels_do_not_take(self, cuda):
        q = torch.zeros(1, 4, 2, 24, device=cuda)
        with pytest.raises(ValueError, match="head_dim"):
            flash_attention(q, q, q)
        with pytest.raises(TypeError):
            h = torch.zeros(1, 4, 2, 8, device=cuda, dtype=torch.float16)
            flash_attention(h, h, h)
        with pytest.raises(ValueError, match="contiguous"):
            t = torch.zeros(1, 2, 4, 8, device=cuda).transpose(1, 2)
            flash_attention(t, t, t)
        w = torch.zeros(1, 4, 2, 8, device=cuda)
        for window, causal in ((0, True), (4, False)):
            with pytest.raises(ValueError, match="window"):
                flash_attention(w, w, w, causal=causal, window=window)
        args = list(_paged_both(_paged_case(1, 2, 4, 2, 8, 4, 2),
                                "float32", cuda))
        args[3] = args[3].long()
        with pytest.raises(ValueError, match="int32"):
            paged_attention(*args)
