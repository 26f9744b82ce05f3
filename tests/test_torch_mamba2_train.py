"""The port's ``Session.fit`` of Mamba-2 against the JAX package's, on
the CPU, at mamba2-780m's ``SMOKE`` (3 layers, d_model 48, chunk 8,
float32).

A 2-worker fit, H = 2, 6 steps of 2 x 16 tokens a worker, under
``dreamddp``, ``ssgd`` and ``dreamddp-int8``, against the JAX per-step
session from the same parameters (the port's seeded init, carried to
JAX as numpy) and the JAX corpus's batches.  The training forward is
the SSD einsum path (the chunk kernel has no backward), remat on.

* Plan fingerprints **equal**; per-step losses within ``rtol=1e-5``
  (float32 sums in another order), or ``1e-4`` under int8, whose later
  steps start from synced values a flipped code moved (below; read:
  1.5e-5 at step 6).
* Final parameters: ``BULK_SHARE`` of the elements within ``1e-5``;
  every one within ``MAX_ATOL``, the learning rate (Adam turns the
  rounding noise of a near-zero gradient into a step of up to ``lr``),
  or, under int8, within ``1e-5`` plus one code's quantum of its row,
  ``max |row| / 127``: a value at a rounding boundary takes the other
  code on one of the two workers, which moves the worker mean by half a
  quantum (ROADMAP.md C6).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.api import JobConfig as JJobConfig  # noqa: E402
from repro.api import Session as JSession  # noqa: E402
from repro.configs import mamba2_780m as jax_mamba2  # noqa: E402
from repro.data import MarkovCorpus as JMarkovCorpus  # noqa: E402
from repro.models.mamba2 import Mamba2LM as JMamba2LM  # noqa: E402
from repro_torch.api import JobConfig, Session  # noqa: E402
from repro_torch.configs import mamba2_780m  # noqa: E402
from repro_torch.convert import params_to_numpy  # noqa: E402
from repro_torch.models.mamba2 import Mamba2LM  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

torch.set_num_threads(1)

SMOKE = mamba2_780m.SMOKE
LR = 3e-3
STEPS, WORKERS, H, SEQ, BATCH = 6, 2, 2, 16, 2
LOSS_RTOL = {"dreamddp": 1e-5, "ssgd": 1e-5, "dreamddp-int8": 1e-4}
BULK_SHARE = {"dreamddp": 0.999, "ssgd": 0.999, "dreamddp-int8": 0.99}
BULK_ATOL = 1e-5
MAX_ATOL = LR


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("algo", ["dreamddp", "ssgd", "dreamddp-int8"])
def test_session_fit_matches_jax_per_step(algo):
    tp = Mamba2LM(SMOKE).init(torch.Generator().manual_seed(0))
    jp = jax.tree.map(jnp.asarray, params_to_numpy(tp))

    class Given(JMamba2LM):              # the JAX session starts from tp
        def init(self, key):
            return jp

    job = dict(arch="mamba2-780m", smoke=True, algo=algo, workers=WORKERS,
               period=H, seq=SEQ, batch_per_worker=BATCH, lr=LR,
               warmup_steps=2, decay_steps=50)
    js = JSession(JJobConfig(**job, fused_period=False),
                  model=Given(jax_mamba2.SMOKE))
    js.fit(STEPS)

    class Batches:                       # the JAX corpus's batches
        corpus = JMarkovCorpus(vocab=SMOKE.vocab, seq_len=SEQ,
                               batch_per_worker=BATCH, n_workers=WORKERS,
                               seed=0)

        def batch(self, step):
            b = jax.device_get(self.corpus.batch(step))
            return {k: torch.from_numpy(np.array(v)).long()
                    for k, v in b.items()}

        def entropy_floor(self):
            return self.corpus.entropy_floor()

    ts = Session(JobConfig(**job), data=Batches(),
                 params=tree_map(torch.clone, tp), device="cpu")
    assert ts.plan.fingerprint() == js.plan.fingerprint()
    ts.fit(STEPS)
    assert len(ts.history) == STEPS
    np.testing.assert_allclose([h["loss"] for h in ts.history],
                               [h["loss"] for h in js.history],
                               rtol=LOSS_RTOL[algo])

    ours = {k: v.detach().float().numpy()
            for k, v in _flat(ts.state.params).items()}
    theirs = {k: np.asarray(v, np.float32)
              for k, v in _flat(jax.device_get(js.state.params)).items()}
    assert ours.keys() == theirs.keys()
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
