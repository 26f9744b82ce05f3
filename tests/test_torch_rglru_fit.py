"""The port's ``Session.fit`` of the Griffin hybrid against the JAX
package's, on the CPU, at recurrentgemma-9b's ``SMOKE`` (float32).

A 2-worker fit, H = 2, 4 steps, under ``dreamddp`` and
``dreamddp-int8``, against the JAX per-step session from the same
parameters (the port's seeded init, carried to JAX as numpy) and the
JAX corpus's batches.  The partial syncs walk the superblocks, the
``tail`` group and the float32 ``lam`` leaves.

* Plan fingerprints **equal**; per-step losses within ``rtol=1e-5``.
* Final parameters: ``BULK_SHARE`` of the elements within ``1e-5``.
  Under ``dreamddp`` every one within ``MAX_ATOL``, the learning rate:
  Adam turns the rounding noise of a near-zero gradient into a step of
  up to ``lr`` (as ``chip_smoke.py``'s ``TRAIN_REF_TOL`` states).  Under
  int8 every one within ``1e-5`` plus one code's quantum of its row,
  ``max |row| / 127``: a value at a rounding boundary takes the other
  code on one of the two workers, which moves the worker mean by half a
  quantum (ROADMAP.md C6; seen here at 0.50-0.53 of the final row's
  quantum, which stands in for the scale that rounded it).

This file is apart from ``tests/test_torch_rglru.py`` because each
JAX fit compiles for ~15 s.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.api import JobConfig as JJobConfig  # noqa: E402
from repro.api import Session as JSession  # noqa: E402
from repro.configs import recurrentgemma_9b as jax_rg  # noqa: E402
from repro.data import MarkovCorpus as JMarkovCorpus  # noqa: E402
from repro.models.rglru import RGLM as JRGLM  # noqa: E402
from repro_torch.api import JobConfig, Session  # noqa: E402
from repro_torch.configs import recurrentgemma_9b  # noqa: E402
from repro_torch.convert import params_to_numpy  # noqa: E402
from repro_torch.models.rglru import RGLM  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

torch.set_num_threads(1)

SMOKE = recurrentgemma_9b.SMOKE
LR = 3e-3
BULK_SHARE = {"dreamddp": 0.999, "dreamddp-int8": 0.99}
BULK_ATOL = 1e-5
MAX_ATOL = LR


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("algo", ["dreamddp", "dreamddp-int8"])
def test_session_fit_matches_jax_per_step(algo):
    tp = RGLM(SMOKE).init(torch.Generator().manual_seed(0))
    jp = jax.tree.map(jnp.asarray, params_to_numpy(tp))

    class Given(JRGLM):                  # the JAX session starts from tp
        def init(self, key):
            return jp

    job = dict(arch="recurrentgemma-9b", smoke=True, algo=algo, workers=2,
               period=2, seq=16, batch_per_worker=2, lr=LR, warmup_steps=2,
               decay_steps=50)
    js = JSession(JJobConfig(**job, fused_period=False),
                  model=Given(jax_rg.SMOKE))
    js.fit(4)

    class Batches:                       # the JAX corpus's batches
        corpus = JMarkovCorpus(vocab=SMOKE.vocab, seq_len=16,
                               batch_per_worker=2, n_workers=2, seed=0)

        def batch(self, step):
            b = jax.device_get(self.corpus.batch(step))
            return {k: torch.from_numpy(np.array(v)).long()
                    for k, v in b.items()}

        def entropy_floor(self):
            return self.corpus.entropy_floor()

    ts = Session(JobConfig(**job), data=Batches(),
                 params=tree_map(torch.clone, tp), device="cpu")
    assert ts.plan.fingerprint() == js.plan.fingerprint()
    ts.fit(4)
    np.testing.assert_allclose([h["loss"] for h in ts.history],
                               [h["loss"] for h in js.history], rtol=1e-5)

    ours = {k: v.detach().float().numpy()
            for k, v in _flat(ts.state.params).items()}
    theirs = {k: np.asarray(v, np.float32)
              for k, v in _flat(jax.device_get(js.state.params)).items()}
    assert ours.keys() == theirs.keys()
    assert any("/lam" in k for k in ours) and any(
        k.startswith("/tail/") for k in ours)
    n = bulk = 0
    for k in ours:
        diff = np.abs(ours[k] - theirs[k])
        limit = MAX_ATOL
        if algo == "dreamddp-int8":     # one code's quantum of the row
            row = theirs[k].reshape(-1, theirs[k].shape[-1])
            quantum = np.abs(row).max(-1) / 127
            limit = BULK_ATOL + quantum.reshape(theirs[k].shape[:-1] + (1,))
        assert (diff <= limit).all(), (k, float(diff.max()))
        n += diff.size
        bulk += int((diff <= BULK_ATOL).sum())
    assert bulk >= BULK_SHARE[algo] * n, bulk / n
