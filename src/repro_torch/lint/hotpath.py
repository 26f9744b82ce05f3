"""Hot-path and consumption marking: the contract between runtime code
and the HOST-SYNC, RECOMPILE and DONATE rules.

Counterpart of ``repro.lint.hotpath``.  Functions on a dispatch-overlap
critical path (the fused period loop, the serve decode tick, the
prefetcher, the async runner) are marked with :func:`hot_path`.  The
HOST-SYNC and RECOMPILE rules police only marked functions, so the rest
of the package can ``float()`` metrics freely: the analyzer keeps
*implicit* device syncs out of exactly the regions whose speed depends on
asynchronous CUDA dispatch.

:func:`consumes` marks a function that updates arguments in place and
hands them back (``Runner.run`` consumes its state): the DONATE rule
flags a read of such an argument after the call, unless the result was
bound to the same name.

Both decorators are pure annotations (an attribute, no wrapper frame, no
cost at run time), detected *statically* by the analyzer: any decorator
whose dotted name ends in ``hot_path`` or ``consumes``.
``EXTRA_HOT_PATHS`` covers functions that cannot carry a decorator:
``"<module>:<qualname>"`` entries, e.g.
``"repro_torch.runtime.runner:Runner._run_fused"``.
"""

from __future__ import annotations

from typing import Callable, TypeVar

F = TypeVar("F", bound=Callable)

# "<dotted.module>:<qualname>" entries for functions that can't be
# decorated.  Checked by the engine next to the decorator scan.
EXTRA_HOT_PATHS: frozenset[str] = frozenset()


def hot_path(fn: F) -> F:
    """Mark ``fn`` as dispatch-overlap critical.

    Inside a hot function the analyzer rejects implicit device syncs
    (``.item()`` / ``.tolist()`` / ``.numpy()`` / ``float()`` / ``if
    tensor:`` / ``np.asarray`` / boolean masks of device values) and
    per-call ``torch.compile`` or graph capture.  Intentional syncs use
    the explicit forms (``.cpu()``, ``.to("cpu")``,
    ``torch.cuda.synchronize()``, ``Event.synchronize()``) or a ``#
    repro-lint: disable=HOST-SYNC`` pragma with a justification.
    """
    fn.__repro_hot_path__ = True
    return fn


def consumes(*argnames: str) -> Callable[[F], F]:
    """Mark the parameters ``argnames`` of the decorated function as
    consumed: updated in place and not to be read after the call except
    through the value it returns (``state = runner.run(state, n)``)."""
    def mark(fn: F) -> F:
        fn.__repro_consumes__ = tuple(argnames)
        return fn
    return mark
