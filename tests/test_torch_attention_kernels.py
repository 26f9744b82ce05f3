"""The two attention kernels' designs: split-K paged decode and the
tensor-core flash prefill.

On the CPU: the split-K arithmetic (``paged_attention_split_ref``: the
kernel's page ranges and its merge of the ``(m, l, acc)`` partials)
against the JAX package's paged attention in interpret mode and its
ref, for several split sizes, with a slot that reads nothing, empty
splits and windows; the host-side split chooser; the flash plain version
against the JAX kernel at GQA group 8 and ragged lengths.  Tolerance:
float32 ``atol=rtol=1e-5`` (summation order), bfloat16 ``1e-2`` (JAX
rounds the probabilities to bfloat16).

On the card (``-m gpu``; skipped without CUDA): the CUDA kernels against
their plain versions, float32 ``2e-5`` and bfloat16 ``2e-2`` (the kernels
keep probabilities in float32 where the plain versions round them to
bfloat16), at every head width (8-256), GQA groups 1-8, ragged and steep
cases, Griffin's width 256 at groups 1 and 16 with its window of 2048 and
its rings read as pages, and two paged calls bitwise equal; bfloat16 paged runs also against the
split-K plain version in float32 at ``2e-3 + 1.6e-2 * |plain|``.  Run there with
``python -m pytest --noconftest -q -m gpu tests/test_torch_*.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.device  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ops import HEAD_DIMS  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention, paged_attention_split_ref, split_pages)
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402

torch.set_num_threads(1)

_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
_KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _to_torch(x, dtype, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        device=device, dtype=getattr(torch, dtype))


def _to_jax(x, dtype):
    jnp = pytest.importorskip("jax").numpy
    return jnp.asarray(x, getattr(jnp, dtype))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_f32(a), _f32(b), rtol=tol, atol=tol)


def _pool(seed, slots, nq, nkv, hd, ps, mb, lens):
    """A random page pool with disjoint per-slot block tables; ``lens``
    are the slots' kv_len, entries past a slot's pages point at trash
    page 0 (all of them for kv_len 0)."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + slots * mb
    q = rng.standard_normal((slots, nq, hd), np.float32)
    kp = rng.standard_normal((n_pages, ps, nkv, hd), np.float32)
    vp = rng.standard_normal((n_pages, ps, nkv, hd), np.float32)
    bt = rng.permutation(np.arange(1, n_pages)).reshape(slots, mb)
    kv_len = np.asarray(lens, np.int32)
    for s in range(slots):
        bt[s, -(-int(kv_len[s]) // ps):] = 0
    return q, kp, vp, bt.astype(np.int32), kv_len


def _torch_args(case, dtype, device="cpu"):
    q, kp, vp, bt, kv_len = case
    return (_to_torch(q, dtype, device), _to_torch(kp, dtype, device),
            _to_torch(vp, dtype, device), torch.from_numpy(bt).to(device),
            torch.from_numpy(kv_len).to(device))


# slots 4, 8/2 heads, hd 16, pages of 4, 9 blocks: one slot reads
# nothing, one ends on a page boundary, one reads all 36 keys
_LENS = [0, 8, 23, 36]


# ---------------------------------------------------------------------------
# split-K paged attention: plain arithmetic vs JAX (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pps", [1, 2, 4, 9])
@pytest.mark.parametrize("window", [None, 3, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_split_ref_matches_jax(pps, window, dtype):
    """pps 1: most splits visit nothing; window 3 with pages of 4: every
    split before the window's page is skipped."""
    from repro.kernels.paged_attention import paged_attention as jax_paged
    case = _pool(pps + (window or 0), 4, 8, 2, 16, 4, 9, _LENS)
    q, kp, vp, bt, kv_len = case
    got = paged_attention_split_ref(*_torch_args(case, dtype),
                                    pages_per_split=pps, window=window)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    jargs = (_to_jax(q, dtype), _to_jax(kp, dtype), _to_jax(vp, dtype),
             _to_jax(bt, "int32"), _to_jax(kv_len, "int32"))
    # the TPU kernel skips every page of a kv_len-0 slot: output 0
    _close(got, jax_paged(*jargs, window=window, impl="interpret"),
           _TOL[dtype])
    # the JAX ref softmaxes a kv_len-0 slot over masked keys; compare the
    # slots that read something
    live = kv_len > 0
    _close(_f32(got)[live],
           np.asarray(jax_paged(*jargs, window=window, impl="ref"),
                      np.float32)[live], _TOL[dtype])
    assert not _f32(got)[~live].any()


def test_paged_split_ref_equals_wrapper_plain_version():
    """Every split size gives the plain version's output on live slots."""
    case = _pool(5, 4, 8, 2, 16, 4, 9, _LENS)
    args = _torch_args(case, "float32")
    want = paged_attention(*args)
    live = case[4] > 0
    for pps in range(1, 10):
        got = paged_attention_split_ref(*args, pages_per_split=pps)
        _close(_f32(got)[live], _f32(want)[live], 1e-5)


# ---------------------------------------------------------------------------
# the host-side split chooser
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slots", [1, 2, 8, 64])
@pytest.mark.parametrize("n_kv", [1, 8])
@pytest.mark.parametrize("max_blocks", [1, 2, 3, 34, 64, 128, 1000])
@pytest.mark.parametrize("sms", [1, 132])
def test_split_pages_covers_the_table_exactly(slots, n_kv, max_blocks, sms):
    splits, pps = split_pages(slots, n_kv, max_blocks, sms)
    assert 1 <= pps <= max_blocks
    assert splits * pps >= max_blocks > (splits - 1) * pps
    assert pps >= min(2, max_blocks)
    # enough blocks for two waves, unless the pages run out first
    assert slots * n_kv * splits >= min(2 * sms, slots * n_kv
                                        * -(-max_blocks // 2))


def test_split_pages_at_the_serve_geometries():
    assert split_pages(8, 8, 34, 132) == (12, 3)    # serve: 8 slots
    assert split_pages(1, 8, 64, 132) == (32, 2)    # one slot, 1024 deep
    assert split_pages(8, 8, 1, 132) == (1, 1)


def test_launch_plan_reads_no_tensor_data(monkeypatch):
    """The plan comes from shapes alone: meta tensors hold no data, so any
    read of kv_len or the block table would raise."""
    monkeypatch.setitem(repro_torch.device._SMS, 0, 132)
    q = torch.empty(8, 32, 64, device="meta", dtype=torch.bfloat16)
    pages = torch.empty(273, 16, 8, 64, device="meta", dtype=torch.bfloat16)
    bt = torch.empty(8, 34, device="meta", dtype=torch.int32)
    assert paged_ops.launch_plan(q, pages, bt) == (12, 3)


# ---------------------------------------------------------------------------
# flash attention: plain version vs JAX at GQA group 8 (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,sq,sk,nq,nkv,hd,causal", [
    (1, 130, 130, 8, 1, 16, True),      # g 8, sq past two tiles
    (1, 33, 57, 8, 1, 8, False),        # g 8, non-causal, sk != sq
])
def test_flash_ref_matches_jax_kernel_group_8(b, sq, sk, nq, nkv, hd,
                                              causal):
    from repro.kernels.flash_attention.kernel import flash_attention_fwd
    rng = np.random.default_rng(sq + sk)
    q = rng.standard_normal((b, sq, nq, hd), np.float32)
    k = rng.standard_normal((b, sk, nkv, hd), np.float32)
    v = rng.standard_normal((b, sk, nkv, hd), np.float32)
    got = flash_attention(_to_torch(q, "float32"), _to_torch(k, "float32"),
                          _to_torch(v, "float32"), causal=causal)
    want = flash_attention_fwd(_to_jax(q, "float32"), _to_jax(k, "float32"),
                               _to_jax(v, "float32"), causal=causal,
                               block_q=64, block_k=64, interpret=True)
    _close(got, want, _TOL["float32"])


# ---------------------------------------------------------------------------
# CUDA kernels vs their plain versions (on the card only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel-vs-ref runs on the card)")
    return torch.device("cuda")


def _flash_inputs(seed, b, sq, sk, nq, nkv, hd, dtype, device, q_mul=1.0):
    rng = np.random.default_rng(seed)
    return (_to_torch(rng.standard_normal((b, sq, nq, hd), np.float32)
                      * q_mul, dtype, device),
            _to_torch(rng.standard_normal((b, sk, nkv, hd), np.float32),
                      dtype, device),
            _to_torch(rng.standard_normal((b, sk, nkv, hd), np.float32),
                      dtype, device))


def _paged_check_f32(got, args, window=None):
    """A bfloat16 kernel run against the split-K plain version in float32
    on the same values, at ``chip_smoke.py``'s bfloat16 tolerance ``2e-3
    + 1.6e-2 * |plain|``: tight enough that a merge dropping one split
    shows."""
    _, pps = paged_ops.launch_plan(args[0], args[1], args[3])
    want = paged_attention_split_ref(
        *(t.cpu().float() if t.is_floating_point() else t.cpu()
          for t in args), pages_per_split=pps, window=window)
    excess = (got.cpu().float() - want).abs() - 2e-3 - 1.6e-2 * want.abs()
    assert excess.max().item() <= 0


def _flash_check(q, k, v, dtype, **kw):
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert torch.isfinite(got.float()).all()
    _close(got, flash_attention(q, k, v, **kw, impl="ref"),
           _KERNEL_TOL[dtype])


@pytest.mark.gpu
class TestAttentionKernelsOnTheCard:
    @pytest.mark.parametrize("hd", HEAD_DIMS)
    @pytest.mark.parametrize("g", [1, 2, 3, 4, 5, 7, 8])
    def test_flash_bf16_every_width_and_group(self, cuda, hd, g):
        _flash_check(*_flash_inputs(hd + g, 2, 130, 130, 2 * g, 2, hd,
                                    "bfloat16", cuda), "bfloat16")

    @pytest.mark.parametrize("hd", HEAD_DIMS)
    @pytest.mark.parametrize("g", [1, 3, 4, 5, 7, 8])
    def test_flash_f32_every_width_and_group(self, cuda, hd, g):
        """The 3xTF32 float32 kernel at every width and GQA group (3, 5
        and 7: a 16-row tile spans part of a position)."""
        _flash_check(*_flash_inputs(hd + g, 2, 130, 130, 2 * g, 2, hd,
                                    "float32", cuda), "float32")

    @pytest.mark.parametrize("hd", HEAD_DIMS)
    def test_flash_f32_window_and_non_causal(self, cuda, hd):
        """float32 with a window (g 4) and non-causal with sk != sq (g 8,
        sk above and below sq)."""
        _flash_check(*_flash_inputs(hd, 2, 200, 200, 8, 2, hd, "float32",
                                    cuda), "float32", window=37)
        for sq, sk in ((70, 150), (150, 33)):
            _flash_check(*_flash_inputs(hd + sk, 1, sq, sk, 8, 1, hd,
                                        "float32", cuda), "float32",
                         causal=False)

    @pytest.mark.parametrize("hd", HEAD_DIMS)
    def test_flash_bf16_wide_grid(self, cuda, hd):
        """A grid of more than two 64-row blocks an SM: the 32-rows-a-warp
        instantiation below hd 128."""
        _flash_check(*_flash_inputs(hd, 4, 520, 520, 32, 8, hd, "bfloat16",
                                    cuda), "bfloat16")

    @pytest.mark.parametrize("sq", [100, 130, 257])
    @pytest.mark.parametrize("hd,g", [(64, 4), (8, 8), (128, 2)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_flash_ragged_lengths(self, cuda, sq, hd, g, dtype):
        _flash_check(*_flash_inputs(sq, 1, sq, sq, 2 * g, 2, hd, dtype,
                                    cuda), dtype)

    @pytest.mark.parametrize("sq,sk", [(100, 257), (130, 40), (1, 65)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_flash_non_causal(self, cuda, sq, sk, dtype):
        _flash_check(*_flash_inputs(sq + sk, 2, sq, sk, 8, 1, 32, dtype,
                                    cuda), dtype, causal=False)

    @pytest.mark.parametrize("window", [1, 5, 64, 1000])
    @pytest.mark.parametrize("g", [1, 8])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_flash_windows(self, cuda, window, g, dtype):
        _flash_check(*_flash_inputs(window + g, 2, 257, 257, 2 * g, 2, 32,
                                    dtype, cuda), dtype, window=window)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_flash_steep_scores(self, cuda, dtype):
        """q x 30: scores of a few hundred drive the running max up tile
        after tile."""
        _flash_check(*_flash_inputs(30, 2, 257, 257, 8, 2, 64, dtype, cuda,
                                    q_mul=30.0), dtype)

    @pytest.mark.parametrize("sq", [2100, 1500, 333])
    @pytest.mark.parametrize("g", [1, 16])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_flash_griffin_width_256(self, cuda, sq, g, dtype):
        """recurrentgemma's local attention: width 256, GQA group 1 or 16
        (MQA: 16 heads over one), window 2048 (at sq 2100 the window's
        first key falls inside a key tile), ragged sq below it."""
        _flash_check(*_flash_inputs(sq + g, 1, sq, sq, g, 1, 256, dtype,
                                    cuda), dtype, window=2048)

    @pytest.mark.parametrize("sq", [1, 400, 1500])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_flash_whisper_non_causal_over_1500_frames(self, cuda, sq,
                                                       dtype):
        """Whisper's encoder (sq = sk = 1500) and cross prefill (a prompt
        against the frames): 16/16 heads of width 64, non-causal, 1500
        keys (not a multiple of the key tile)."""
        q, k, v = _flash_inputs(sq, 2, sq, 1500, 16, 16, 64, dtype, cuda)
        _flash_check(q, k, v, dtype, causal=False)

    @pytest.mark.parametrize("s", [577, 1088])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_flash_llava_group_7(self, cuda, s, dtype):
        """llava-next-34b's prefill: 56/8 heads (g 7) of width 128,
        causal, a 576-patch prefix and up to 512 text tokens."""
        _flash_check(*_flash_inputs(s, 1, s, s, 56, 8, 128, dtype, cuda),
                     dtype)

    @pytest.mark.parametrize("depth,kv_len", [(1500, [1500, 1500, 1500]),
                                              (448, [1, 16, 448])])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_paged_whisper_lane_as_pages(self, cuda, depth, kv_len, dtype):
        """Whisper's decode: 3 contiguous lanes of ``depth`` keys, 16
        heads of width 64 (g 1), seen as pages through
        ``WhisperModel.lane_table`` — the cross lanes of 1500 frames as
        pages of 4 at ``kv_len = 1500``, self lanes of 448 as pages of
        16 (lane 0 reading page 0 alone)."""
        from repro_torch.configs import whisper_medium
        from repro_torch.models.whisper import WhisperModel
        model = WhisperModel(whisper_medium.CONFIG)
        ps = model.lane_page(depth)
        assert ps == (4 if depth == 1500 else 16)
        rng = np.random.default_rng(depth)
        lanes = [rng.standard_normal((3, depth, 16, 64), np.float32)
                 for _ in "kv"]
        table = model.lane_table(3, depth, cuda)
        args = (_to_torch(rng.standard_normal((3, 16, 64), np.float32),
                          dtype, cuda),
                *(_to_torch(x, dtype, cuda).view(-1, ps, 16, 64)
                  for x in lanes), table,
                torch.tensor(kv_len, dtype=torch.int32, device=cuda))
        got = paged_attention(*args)
        torch.cuda.synchronize()
        _close(got, paged_attention(*args, impl="ref"), _KERNEL_TOL[dtype])
        if dtype == "bfloat16":
            _paged_check_f32(got, args)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_paged_griffin_ring_as_pages(self, cuda, dtype):
        """Width 256, 16 query heads over one, each slot's ring of 64
        keys seen as 4 pages of 16 through ``RGLM.ring_table`` (the table
        two rings wide, the rings at pool pages ``4 b .. 4 b + 3``): slot
        0 at kv_len 1 reads pool page 0; kv_len 64, 65 and 200 fill and
        wrap the ring, folded into (64, 128] as the model folds them."""
        import dataclasses
        from repro_torch.configs import recurrentgemma_9b
        from repro_torch.models.rglru import RGLM
        model = RGLM(dataclasses.replace(recurrentgemma_9b.CONFIG,
                                         window=64))
        lens = np.array([1, 64, 65, 200])
        rng = np.random.default_rng(22)
        q = rng.standard_normal((4, 16, 256), np.float32)
        kp = rng.standard_normal((16, 16, 1, 256), np.float32)
        vp = rng.standard_normal((16, 16, 1, 256), np.float32)
        fold = np.where(lens > 64, (lens - 1) % 64 + 1 + 64, lens)
        table = model.ring_table(4, cuda)
        assert table[0, 0].item() == 0 and table.shape == (4, 8)
        args = (_to_torch(q, dtype, cuda), _to_torch(kp, dtype, cuda),
                _to_torch(vp, dtype, cuda), table,
                torch.from_numpy(fold.astype(np.int32)).to(cuda))
        got = paged_attention(*args, window=64)
        torch.cuda.synchronize()
        _close(got, paged_attention(*args, window=64, impl="ref"),
               _KERNEL_TOL[dtype])
        if dtype == "bfloat16":
            _paged_check_f32(got, args, 64)

    @pytest.mark.parametrize("slots,mb", [(1, 64), (1, 128), (2, 64),
                                          (2, 128)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_paged_few_slots_deep_tables(self, cuda, slots, mb, dtype):
        """Few slots over deep tables: many splits a slot."""
        lens = [mb * 16 - 5, 3 * 16][:slots]
        args = _torch_args(_pool(mb + slots, slots, 32, 8, 64, 16, mb, lens),
                           dtype, cuda)
        assert paged_ops.launch_plan(args[0], args[1], args[3])[0] > 1
        before = paged_attention.launches
        got = paged_attention(*args)
        torch.cuda.synchronize()
        assert paged_attention.launches == before + 1
        _close(got, paged_attention(*args, impl="ref"), _KERNEL_TOL[dtype])
        if dtype == "bfloat16":
            _paged_check_f32(got, args)

    @pytest.mark.parametrize("window", [None, 1, 5, 40, 1000])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_paged_empty_lane_page_boundary_and_windows(self, cuda, window,
                                                        dtype):
        """kv_len 0 gives 0; kv_len 16 and 48 end on a page boundary."""
        lens = [0, 16, 48, 1, 200, 1024]
        case = _pool(len(lens), len(lens), 32, 8, 64, 16, 64, lens)
        args = _torch_args(case, dtype, cuda)
        got = paged_attention(*args, window=window)
        torch.cuda.synchronize()
        want = paged_attention(*args, window=window, impl="ref")
        assert not got[0].float().abs().max()
        _close(got[1:], want[1:], _KERNEL_TOL[dtype])
        if dtype == "bfloat16":
            _paged_check_f32(got, args, window)

    @pytest.mark.parametrize("slots,mb", [(8, 34), (1, 64)])
    def test_paged_two_calls_bitwise_equal(self, cuda, slots, mb):
        lens = list(range(mb * 16, 0, -(mb * 16) // slots))[:slots]
        args = _torch_args(_pool(3, slots, 32, 8, 64, 16, mb, lens),
                           "bfloat16", cuda)
        first = paged_attention(*args)
        second = paged_attention(*args)
        torch.cuda.synchronize()
        assert torch.equal(first, second)

    def test_paged_plain_split_arithmetic_on_the_card(self, cuda):
        """The kernel against the split-K plain version at the launch's
        own split size."""
        lens = [0, 16, 300, 1024]
        case = _pool(9, 4, 32, 8, 64, 16, 64, lens)
        args = _torch_args(case, "float32", cuda)
        _, pps = paged_ops.launch_plan(args[0], args[1], args[3])
        want = paged_attention_split_ref(*_torch_args(case, "float32"),
                                         pages_per_split=pps)
        _close(paged_attention(*args), want, _KERNEL_TOL["float32"])
