"""The port's SimNet (``repro_torch.sim``) against the JAX package's.

SimNet is a framework-free copy, so its outputs must be **equal**, not
close: every library scenario x (``dreamddp``, ``plsgd-enp``,
``flsgd``), on ``synthetic_profile`` (equal in both packages), gives

* ``check_scenario``: the same trace fingerprint, the same windows
  (period, expected and simulated seconds, compared with ``==``) and
  the same skipped periods;
* ``Session.simulate`` in sync mode with replans: the same plan history
  (iteration of each replan, plan fingerprints) and trace fingerprint;
* ``Session.simulate`` in async mode: the same trace fingerprint; and,
  for jitter-free scenarios, ``check_async_scenario``'s windows equal.

These are cases of one parametrised test.  Also here: the
``python -m repro_torch.sim`` sweep, and ``measured_profile`` on trivial
thunks (the fp/bp split by ``bwd_fwd_ratio``, ``t_comm`` the ring
all-reduce time).
"""

import dataclasses

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.api import JobConfig as JJobConfig  # noqa: E402
from repro.api import Session as JSession  # noqa: E402
from repro.hier import check_async_scenario as j_check_async  # noqa: E402
from repro.sim import available_scenarios as j_available  # noqa: E402
from repro.sim import check_scenario as j_check  # noqa: E402
from repro.sim import get_scenario as j_get_scenario  # noqa: E402
from repro.sim import synthetic_profile as j_synthetic  # noqa: E402
from repro_torch.api import JobConfig, Session  # noqa: E402
from repro_torch.core.profiler import (HardwareSpec,  # noqa: E402
                                       measured_profile,
                                       ring_allreduce_time)
from repro_torch.hier import check_async_scenario  # noqa: E402
from repro_torch.sim import (available_scenarios, check_scenario,  # noqa: E402
                             get_scenario, synthetic_profile)

ALGOS = ("dreamddp", "plsgd-enp", "flsgd")
H = 4


def _windows(report):
    return [(c.period, c.expected, c.simulated) for c in report.checks]


def _plans(report):
    return [(at, plan.fingerprint()) for at, plan in report.plans]


def _jitter(sc) -> bool:
    return any(spec.jitter > 0 for spec in (sc.intra, sc.inter)
               if spec is not None)


def test_library_and_profile_are_the_references():
    assert available_scenarios() == j_available()
    for name in available_scenarios():
        assert repr(get_scenario(name)) == repr(j_get_scenario(name))
    assert synthetic_profile().to_json() == j_synthetic().to_json()


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("name", sorted(j_available()))
def test_sim_matches_jax(name, algo):
    sc, jsc = get_scenario(name), j_get_scenario(name)
    prof, jprof = synthetic_profile(), j_synthetic()
    if not _jitter(sc):
        mine = check_scenario(sc, algo=algo, H=H, profile=prof)
        ref = j_check(jsc, algo=algo, H=H, profile=jprof)
        assert mine.trace.fingerprint() == ref.trace.fingerprint()
        assert _windows(mine) == _windows(ref) and mine.checks
        assert mine.skipped_periods == ref.skipped_periods
        assert mine.ok
        amine = check_async_scenario(sc, algo=algo, H=H, profile=prof)
        aref = j_check_async(jsc, algo=algo, H=H, profile=jprof)
        assert amine.trace.fingerprint() == aref.trace.fingerprint()
        assert _windows(amine) == _windows(aref) and amine.ok

    job = dict(algo=algo, workers=sc.n_workers, period=H)
    sess = Session(JobConfig(**job), device="cpu")
    jsess = JSession(JJobConfig(**job))
    for mode in ("sync", "async"):
        mine = sess.simulate(name, profile=prof, mode=mode)
        ref = jsess.simulate(name, profile=jprof, mode=mode)
        assert mine.trace.fingerprint() == ref.trace.fingerprint(), mode
        assert _plans(mine) == _plans(ref), mode
        assert mine.summary() == ref.summary(), mode
    assert sess._runner is None and sess._state is None  # analysis only


def test_sim_cli_sweeps_the_library(capsys):
    from repro_torch.sim.__main__ import main
    assert main(["--algo", "dreamddp"]) == 0
    out = capsys.readouterr().out
    n = sum(not _jitter(get_scenario(s)) for s in available_scenarios())
    assert f"{n}/{n} conformance checks passed" in out


def test_measured_profile_splits_trivial_thunks():
    hw = HardwareSpec(bandwidth=1e8, n_workers=4)
    calls = []
    fns = [(f"l{i}", (lambda i=i: calls.append(i)), 1000.0 * (i + 1))
           for i in range(3)]
    prof = measured_profile(fns, hw, warmup=1, iters=3)
    assert calls == [0] * 4 + [1] * 4 + [2] * 4
    assert [c.name for c in prof.layers] == ["l0", "l1", "l2"]
    for c, (_, _, nbytes) in zip(prof.layers, fns, strict=True):
        assert c.t_fp >= 0.0
        assert c.t_bp == pytest.approx(c.t_fp * hw.bwd_fwd_ratio)
        assert c.t_comm == ring_allreduce_time(nbytes, hw)
        assert c.param_bytes == nbytes
    # a measured profile is a profile like any other: it plans and replays
    sess = Session(JobConfig(workers=4, period=2), device="cpu")
    report = sess.simulate(dataclasses.replace(
        get_scenario("homogeneous"), n_workers=4), profile=prof)
    assert report.trace.n_periods == get_scenario("homogeneous").periods
