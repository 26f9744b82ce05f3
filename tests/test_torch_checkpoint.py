"""The port's checkpoint manager against the JAX package's, on the CPU.

* The six tests of ``tests/test_checkpoint.py`` on torch tensors:
  roundtrip, keep-k, no ``.tmp`` left behind, async save then wait, a
  missing checkpoint, and ``reshard_workers`` (every new replica the old
  mean, ``rtol=1e-6``).
* bfloat16 leaves round-trip bit for bit without ``ml_dtypes`` (stored
  as raw 16 bits, ``"bfloat16"`` in the manifest).
* A float32 granite smoke ``TrainState`` (2 workers, int8 error-feedback
  residuals included) written by ``repro.checkpoint.CheckpointManager``
  restores into the port, and one the port writes restores through the
  reference: keys, shapes and values equal.
* ``restore(template, in_place=True)`` writes into the template's own
  tensors (every ``data_ptr()`` kept) and refuses a leaf of another
  shape; a failed background save surfaces on ``wait()``.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402,E501
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro.runtime import StepConfig as JStepConfig  # noqa: E402
from repro.runtime import init_train_state as jinit  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    reshard_workers)
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.runtime import StepConfig, init_train_state  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def _state(seed, w=4, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"a": torch.randn(w, 3, 5, generator=g).to(dtype),
                   "b": torch.randn(w, 7, generator=g).to(dtype)},
        "step": torch.tensor(13, dtype=torch.int32),
    }


def _leaves(tree):
    return [x for x in tree_leaves(tree) if x is not None]


def test_roundtrip(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep=2)
    s = _state(0)
    ck.save(10, s, meta={"x": 1}, block=True)
    step, got, meta = ck.restore(s)
    assert step == 10 and meta == {"x": 1}
    for a, b in zip(_leaves(s), _leaves(got), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_keep_k_gc(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep=2)
    s = _state(1)
    for step in (1, 2, 3, 4):
        ck.save(step, s, block=True)
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000003", "step_00000004"]
    assert ck.latest_step() == 4


def test_no_tmp_left_behind(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    ck.save(5, _state(2), block=True)
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


def test_async_save_then_wait(tmp_path):
    ck = CheckpointManager(str(tmp_path), async_save=True)
    ck.save(7, _state(3))
    ck.wait()
    assert ck.latest_step() == 7


def test_restore_missing(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ck.restore({"a": torch.zeros(1)})


def test_reshard_workers_mean_property():
    s = _state(4, w=4)
    out = reshard_workers(s["params"], 6)
    for k in ("a", "b"):
        assert out[k].shape[0] == 6
        # every new replica equals the old mean
        want = s["params"][k].numpy().mean(0)
        for i in range(6):
            np.testing.assert_allclose(out[k][i].numpy(), want, rtol=1e-6)


def test_bfloat16_roundtrips_exactly_without_ml_dtypes(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    s = _state(5, dtype=torch.bfloat16)
    s["params"]["a"][0, 0, :3] = torch.tensor([float("inf"), -0.0, 1e-40])
    ck.save(3, s, block=True)
    with open(tmp_path / "step_00000003" / "manifest.json") as f:
        dtypes = {e["key"]: e["dtype"] for e in json.load(f)["leaves"]}
    assert dtypes == {"params/a": "bfloat16", "params/b": "bfloat16",
                      "step": "int32"}
    _, got, _ = ck.restore(s)
    for a, b in zip(_leaves(s), _leaves(got), strict=True):
        assert b.dtype == a.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)


def test_restore_in_place_keeps_every_address(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    saved = _state(6)
    ck.save(9, saved, block=True)
    target = _state(7)
    ptrs = [x.data_ptr() for x in _leaves(target)]
    step, got, _ = ck.restore(target, in_place=True)
    assert step == 9 and got is target
    assert [x.data_ptr() for x in _leaves(target)] == ptrs
    for a, b in zip(_leaves(saved), _leaves(target), strict=True):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="in-place restore"):
        ck.restore(_state(8, w=3), in_place=True)


def test_failed_background_save_surfaces_on_wait(tmp_path):
    ck = CheckpointManager(str(tmp_path / "ck"))
    os.rmdir(tmp_path / "ck")
    (tmp_path / "ck").write_text("not a directory")
    ck.save(1, _state(9))
    with pytest.raises(OSError):
        ck.wait()


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------

W = 2


def _jax_state():
    model = jget_arch("granite-3-2b").make_smoke()
    return jinit(model, jmake_optimizer("adam"), jax.random.PRNGKey(0), W,
                 cfg=JStepConfig(compress="int8_ef"))


def _port_state(seed):
    model = get_arch("granite-3-2b").make_smoke()
    return init_train_state(model, make_optimizer("adam"),
                            torch.Generator().manual_seed(seed), W,
                            cfg=StepConfig(compress="int8_ef"))


def _jax_keyed(state):
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {"/".join(str(getattr(p, "name", getattr(p, "key", p)))
                     for p in path): np.asarray(leaf) for path, leaf in flat}


def _port_keyed(state):
    from repro_torch.checkpoint.manager import _keyed_leaves
    return {k: v.numpy() for k, v in _keyed_leaves(state)}


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    js = _jax_state()
    JCheckpointManager(str(tmp_path)).save(4, js, meta={"plan": "p"},
                                           block=True)
    target = _port_state(1)
    step, got, meta = CheckpointManager(str(tmp_path)).restore(
        target, in_place=True)
    assert step == 4 and meta == {"plan": "p"}
    want, have = _jax_keyed(js), _port_keyed(got)
    assert sorted(want) == sorted(have) and "ef/embed/table" in have
    for k in want:
        assert have[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)


def test_port_checkpoint_restores_through_the_reference(tmp_path):
    ts = _port_state(2)
    for x in _leaves(ts.ef):
        x.normal_(generator=torch.Generator().manual_seed(3))
    CheckpointManager(str(tmp_path)).save(6, ts, meta={"plan": "q"},
                                          block=True)
    step, got, meta = JCheckpointManager(str(tmp_path)).restore(_jax_state())
    assert step == 6 and meta == {"plan": "q"}
    want, have = _port_keyed(ts), _jax_keyed(got)
    assert sorted(want) == sorted(have)
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)
