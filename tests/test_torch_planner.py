"""The port's planner against the JAX package's.

The planner is pure Python in both packages (the port keeps its own
copies), so everything discrete must agree exactly: the registered
strategy names, every ``SyncPlan`` and its fingerprint for every
strategy x seeded profile x H, the Algorithm-2 partitions and their
objectives (a cheap mirror of ``test_schedule_exhaustive.py``), the
time model and the bubble fills.
"""

import itertools
import random

import pytest

pytest.importorskip("jax")      # the reference's planner imports through jax

from repro.api import available_strategies as jax_strategies  # noqa: E402
from repro.api import get_strategy as jax_get_strategy  # noqa: E402
from repro.core import profiler as jax_profiler  # noqa: E402
from repro.core.bubble_fill import fill_bubbles as jax_fill  # noqa: E402
from repro.core.schedule import dreamddp_schedule as jax_dreamddp  # noqa: E402
from repro.core.time_model import simulate_period as jax_simulate_period  # noqa: E402
from repro_torch.api import available_strategies, get_strategy  # noqa: E402
from repro_torch.core import profiler  # noqa: E402
from repro_torch.core.bubble_fill import fill_bubbles  # noqa: E402
from repro_torch.core.plans import SyncPlan  # noqa: E402
from repro_torch.core.schedule import (brute_force_schedule,  # noqa: E402
                                       dreamddp_schedule, enp_schedule)
from repro_torch.core.time_model import simulate_period  # noqa: E402

from conftest import random_profile as jax_random_profile  # noqa: E402


def _layers(n_layers, seed):
    """The triples of ``conftest.random_profile`` (same draws)."""
    rng = random.Random(seed)
    return [(f"l{i}", rng.uniform(1e6, 5e7), rng.uniform(1e9, 8e10))
            for i in range(n_layers)]


def _both(n_layers, *, seed=0, bandwidth=1e9, n_workers=8):
    kw = dict(bandwidth=bandwidth, n_workers=n_workers, latency=1e-4)
    layers = _layers(n_layers, seed)
    ours = profiler.analytic_profile(layers, profiler.HardwareSpec(**kw))
    ref = jax_profiler.analytic_profile(layers,
                                        jax_profiler.HardwareSpec(**kw))
    return ours, ref


def test_profiles_match_conftest_and_defaults_are_the_references():
    ours, ref = _both(9, seed=3)
    assert ref.to_json() == jax_random_profile(9, seed=3).to_json()
    assert ours.to_json() == ref.to_json()
    assert profiler.HardwareSpec() == profiler.HardwareSpec(
        **jax_profiler.HardwareSpec().__dict__)
    assert profiler.V5E.name == "tpu-v5e"


def test_registry_names_match():
    assert available_strategies() == jax_strategies()


@pytest.mark.parametrize("algo", sorted(jax_strategies()))
@pytest.mark.parametrize("H", [1, 3, 5])
def test_plan_fingerprints_match(algo, H):
    for seed, n_layers, bw in ((0, 12, 1e9), (1, 7, 1e8), (2, 10, 2e10)):
        ours, ref = _both(n_layers, seed=seed, bandwidth=bw)
        mine = get_strategy(algo).build_plan(ours, H)
        theirs = jax_get_strategy(algo).build_plan(ref, H)
        assert mine.to_json() == theirs.to_json(), (algo, H, seed)
        assert mine.fingerprint() == theirs.fingerprint()
        assert SyncPlan.from_json(mine.to_json()) == mine


@pytest.mark.parametrize("L,H", list(itertools.product(range(1, 7),
                                                       range(1, 4))))
def test_schedule_exhaustive_mirror(L, H):
    for seed, bw in itertools.product(range(2), (1e8, 2e10)):
        ours, ref = _both(L, seed=seed, bandwidth=bw)
        mine = dreamddp_schedule(ours, H)
        theirs = jax_dreamddp(ref, H)
        assert mine.partition.counts == theirs.partition.counts
        assert mine.objective == theirs.objective
        assert mine.stats.nodes_visited == theirs.stats.nodes_visited
        exact = dreamddp_schedule(ours, H, refine_exact=False)
        assert exact.objective == pytest.approx(
            brute_force_schedule(ours, H).objective, rel=1e-12)
        assert mine.objective <= enp_schedule(ours, H).objective + 1e-12
        t_ours = simulate_period(ours, mine.partition)
        t_ref = jax_simulate_period(ref, theirs.partition)
        assert [t.iteration_time for t in t_ours] == \
            [t.iteration_time for t in t_ref]
        f_ours = fill_bubbles(ours, mine.partition)
        f_ref = jax_fill(ref, theirs.partition)
        assert f_ours.fills == f_ref.fills
