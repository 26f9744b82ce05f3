"""repro_torch.lint — PyTorch/CUDA-aware static analysis for the port's
invariants (counterpart of ``repro.lint``).

Pure stdlib (``ast``): importing this package never imports torch, jax
or the JAX package, so the linter runs in bare CI containers.  Entry
points::

    python -m repro_torch.lint src/repro_torch   # CLI
    from repro_torch.lint import lint_text       # test / tooling API
    from repro_torch.lint import hot_path        # runtime hot-path marker
    from repro_torch.lint import consumes        # in-place consumer marker

Rule catalogue and suppression syntax: ``src/repro_torch/lint/README.md``.
"""

from .engine import lint_paths, lint_text
from .findings import ERROR, WARNING, Finding
from .hotpath import EXTRA_HOT_PATHS, consumes, hot_path
from .registry import Rule, all_rules, register

__all__ = ["lint_paths", "lint_text", "Finding", "ERROR", "WARNING",
           "hot_path", "consumes", "EXTRA_HOT_PATHS", "Rule", "all_rules",
           "register"]
