"""The reference's last public names in the port, against the JAX
package's on the same numpy inputs.

On the CPU:

* ``data.TeacherImages`` — the teacher's two matrices **equal** to the
  reference's (the same numpy draws), and the reference's own images
  pushed through the port's labelling give **equal** labels; the port's
  images come from its own generators (one stream per worker and step);
* ``kernels.fused_adam_sync.{fused_adamw_step, fused_adamw_tree}``
  against the reference's (its Pallas kernel in interpret mode), float32
  ``rtol=atol=1e-6``, bfloat16 8e-3, and ``adamw_ref`` against the
  reference's ``adamw_ref`` at ``2e-5`` — the tolerances of
  ``tests/test_torch_optim_sync.py`` (ROADMAP C5: the kernels take ``1 -
  beta2`` in float32, 1.3e-5 relative in ``v``);
* ``kernels.int8_quant.{quantize, dequantize}`` — codes and scales
  **equal** to the reference's ``quantize_rows_ref``, values **equal** to
  its ``dequantize_rows_ref`` in float32 and bfloat16; against the
  reference's Pallas ``quantize`` in interpret mode, the allowance of
  its own sweep (XLA:CPU divides by 127 as a product with the
  reciprocal).

On the card (``-m gpu``; skipped without CUDA): each alias's kernel path
against its plain path on the same tensors, with its launches counted.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import TeacherImages  # noqa: E402
from repro_torch.kernels.fused_adam_sync import (adamw_ref,  # noqa: E402
                                                 fused_adamw,
                                                 fused_adamw_step,
                                                 fused_adamw_tree)
from repro_torch.kernels.int8_quant import (dequantize,  # noqa: E402
                                            dequantize_rows, quantize,
                                            quantize_rows)

TEACHER = dict(n_classes=10, image_dim=64, batch_per_worker=5, n_workers=3,
               seed=2)


def _jax():
    jax = pytest.importorskip("jax")
    return jax, jax.numpy


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _adam_case(shape, seed, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    m = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    v = (np.abs(rng.standard_normal(shape)) * 0.01).astype(np.float32)
    pt = torch.from_numpy(p).to(device=device, dtype=dtype)
    return [pt] + [torch.from_numpy(a).to(device) for a in (g, m, v)]


# ------------------------------------------------------------ TeacherImages

def test_teacher_images_equal_the_reference():
    jax, jnp = _jax()
    from repro.data import TeacherImages as JaxTeacher
    d, jd = TeacherImages(**TEACHER), JaxTeacher(**TEACHER)
    np.testing.assert_array_equal(_np(d._w1), np.asarray(jd._w1))
    np.testing.assert_array_equal(_np(d._w2), np.asarray(jd._w2))
    for step in (0, 7):
        jb = jd.batch(step)
        got = d.labels(torch.from_numpy(np.array(jb["images"])))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_np(got), np.asarray(jb["labels"]))


def test_teacher_images_streams():
    d = TeacherImages(**TEACHER)
    b0, b1 = d.batch(0), d.batch(1)
    assert b0["images"].shape == (3, 5, 64) and b0["labels"].shape == (3, 5)
    assert b0["images"].dtype == torch.float32
    assert b0["labels"].dtype == torch.int32
    assert torch.equal(d.batch(0)["images"], b0["images"])   # pure in step
    assert not torch.equal(b1["images"], b0["images"])
    x = b0["images"]
    assert not torch.equal(x[0], x[1]) and not torch.equal(x[1], x[2])
    assert torch.equal(b0["labels"], d.labels(x))
    assert int(b0["labels"].min()) >= 0 and int(b0["labels"].max()) < 10
    # worker k's stream does not depend on how many workers there are
    two = TeacherImages(**{**TEACHER, "n_workers": 2}).batch(0)
    assert torch.equal(two["images"], x[:2])


# ---------------------------------------------------------------- AdamW

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", [0, 100])
def test_fused_adamw_step_and_adamw_ref_match_jax(dtype, step):
    jax, jnp = _jax()
    from repro.kernels.fused_adam_sync import adamw_ref as jadamw_ref
    from repro.kernels.fused_adam_sync import \
        fused_adamw_step as jfused_adamw_step
    p, g, m, v = _adam_case((300, 17), step, getattr(torch, dtype))
    # copies: JAX may alias a numpy buffer and reads it asynchronously,
    # while the port's step below updates p, m and v in place
    jp = jnp.asarray(_np(p).copy(), getattr(jnp, dtype))
    jg, jm, jv = (jnp.asarray(_np(t).copy()) for t in (g, m, v))
    want_k = jfused_adamw_step(jp, jg, jm, jv, 1e-3, step, weight_decay=0.1)
    want_r = jadamw_ref(jp, jg, jm, jv, lr=1e-3, step=step,
                        weight_decay=0.1)

    before = [t.clone() for t in (p, g, m, v)]
    ref = adamw_ref(p, g, m, v, lr=1e-3, step=step, weight_decay=0.1)
    assert all(torch.equal(a, b) for a, b in zip(before, (p, g, m, v),
                                                 strict=True))
    assert ref[0].dtype == p.dtype and ref[1].dtype == torch.float32
    launches = fused_adamw.launches
    got = fused_adamw_step(p, g, m, v, 1e-3, step, weight_decay=0.1)
    assert fused_adamw.launches == launches           # the CPU: plain path
    assert all(a is b for a, b in zip(got, (p, m, v), strict=True))

    tol = 1e-6 if dtype == "float32" else 8e-3
    for a, b in zip(got, want_k, strict=True):
        np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)
    for a, b in zip(ref, want_r, strict=True):
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-5,
                                   atol=max(tol, 2e-5))
    for a, b in zip(got, ref, strict=True):           # one arithmetic
        assert torch.equal(a, b)


def test_fused_adamw_tree_matches_jax():
    jax, jnp = _jax()
    from repro.kernels.fused_adam_sync import \
        fused_adamw_tree as jfused_adamw_tree
    leaves = {"b": _adam_case((7,), 1), "a": {"w": _adam_case((5, 9), 2)}}
    trees = [{"b": leaves["b"][i], "a": {"w": leaves["a"]["w"][i]}}
             for i in range(4)]
    jtrees = [jax.tree_util.tree_map(lambda t: jnp.asarray(_np(t).copy()),
                                     t) for t in trees]
    want = jfused_adamw_tree(*jtrees, 1e-3, 3, weight_decay=0.1)
    got = fused_adamw_tree(*trees, 1e-3, 3, weight_decay=0.1)
    assert got[0] is trees[0] and got[1] is trees[2] and got[2] is trees[3]
    for g_tree, w_tree in zip(got, want, strict=True):
        for key in ("b", "a"):
            a = g_tree["b"] if key == "b" else g_tree["a"]["w"]
            b = w_tree["b"] if key == "b" else w_tree["a"]["w"]
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6,
                                       atol=1e-6)


# ----------------------------------------------------------------- int8

@pytest.mark.parametrize("r,c", [(8, 16), (77, 33)])
@pytest.mark.parametrize("scale", [1e-3, 100.0])
def test_int8_aliases_equal_jax(r, c, scale):
    jax, jnp = _jax()
    from repro.kernels.int8_quant import (dequantize_rows_ref,
                                          quantize_rows_ref)
    from repro.kernels.int8_quant import quantize as jquantize
    rng = np.random.default_rng(r * c)
    x = (rng.standard_normal((r, c)) * scale).astype(np.float32)
    x[1] = 0.0                                        # a zero row
    launches = (quantize_rows.launches, dequantize_rows.launches)
    q, s = quantize(torch.from_numpy(x))
    qr, sr = quantize_rows_ref(jnp.asarray(x))
    np.testing.assert_array_equal(_np(q), np.asarray(qr))
    np.testing.assert_array_equal(_np(s), np.asarray(sr))
    qk, sk = jquantize(jnp.asarray(x))                # Pallas interpret
    diff = np.abs(np.asarray(qk, np.int32) - _np(q).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    np.testing.assert_allclose(_np(s), np.asarray(sk), rtol=1e-6)
    for dtype in ("float32", "bfloat16"):
        d = dequantize(q, s, getattr(torch, dtype))
        assert d.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(_np(d), _np(dequantize_rows_ref(
            qr, sr, dtype=getattr(jnp, dtype))))
    assert (quantize_rows.launches, dequantize_rows.launches) == launches


# ---------------------------------------------------- on the card (gpu)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel-vs-plain runs on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
class TestCudaAliases:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_fused_adamw_step_and_tree_kernel_vs_plain(self, cuda, dtype):
        tdt = getattr(torch, dtype)
        a = _adam_case((1000, 33), 5, tdt, cuda)
        want = adamw_ref(*a, lr=1e-3, step=9, weight_decay=0.1)
        before = fused_adamw.launches
        got = fused_adamw_step(*a, torch.tensor(1e-3, device=cuda), 9,
                               weight_decay=0.1)
        torch.cuda.synchronize()
        assert fused_adamw.launches == before + 1
        tol = 1e-6 if dtype == "float32" else 8e-3
        for x, y in zip(got, want, strict=True):
            np.testing.assert_allclose(_np(x), _np(y), rtol=tol, atol=tol)
        trees = [{"a": x, "b": y} for x, y in zip(
            _adam_case((64,), 1, tdt, cuda), _adam_case((3, 5), 2, tdt, cuda),
            strict=True)]
        plain = [{k: t.clone() for k, t in tree.items()} for tree in trees]
        fused_adamw_tree(*trees, 1e-3, 4)
        assert fused_adamw.launches == before + 3
        for k in ("a", "b"):
            want = adamw_ref(*(t[k] for t in plain), lr=1e-3, step=4)
            for x, y in zip((trees[0][k], trees[2][k], trees[3][k]), want,
                            strict=True):
                np.testing.assert_allclose(_np(x), _np(y), rtol=tol,
                                           atol=tol)

    @pytest.mark.parametrize("r,c", [(77, 33), (64, 2048)])
    def test_int8_aliases_kernel_vs_plain(self, cuda, r, c):
        rng = np.random.default_rng(r + c)
        x = torch.from_numpy((rng.standard_normal((r, c)) * 3)
                             .astype(np.float32)).to(cuda)
        before = (quantize_rows.launches, dequantize_rows.launches)
        q, s = quantize(x)
        d = dequantize(q, s, torch.bfloat16)
        torch.cuda.synchronize()
        assert (quantize_rows.launches, dequantize_rows.launches) == \
            (before[0] + 1, before[1] + 1)
        qr, sr = quantize_rows(x, impl="ref")
        assert torch.equal(q, qr) and torch.equal(s, sr)
        assert torch.equal(d, dequantize_rows(qr, sr, impl="ref")
                           .to(torch.bfloat16))

    def test_teacher_images_on_the_card(self, cuda):
        d = TeacherImages(**TEACHER, device=cuda)
        b = d.batch(3)
        assert b["images"].is_cuda and b["labels"].is_cuda
        assert torch.equal(d.batch(3)["images"], b["images"])
        cpu = TeacherImages(**TEACHER)
        assert torch.equal(d._w1.cpu(), cpu._w1)
        assert torch.equal(b["labels"], d.labels(b["images"]))
