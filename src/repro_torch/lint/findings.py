"""Finding/severity types shared by the analyzer, rules, and reporters.

Copy of ``repro.lint.findings``: the same fingerprint, so a baseline
written by either linter reads alike.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

ERROR = "error"
WARNING = "warning"


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location.

    ``context`` is the qualname of the enclosing function ('' at module
    level); ``line_text`` the stripped source line.  Both feed the
    baseline fingerprint so grandfathered findings survive unrelated
    line-number churn (see :mod:`repro_torch.lint.baseline`).
    """

    rule: str
    severity: str
    path: str                     # posix-style, as handed to the engine
    line: int
    col: int
    message: str
    context: str = ""
    line_text: str = ""

    def fingerprint(self) -> str:
        key = "\x1f".join([self.rule, self.path, self.context,
                           " ".join(self.line_text.split())])
        return hashlib.sha1(key.encode()).hexdigest()[:16]

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "context": self.context,
            "line_text": self.line_text,
            "fingerprint": self.fingerprint(),
        }

    def render(self) -> str:
        where = f" [{self.context}]" if self.context else ""
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"{self.severity}: {self.message}{where}")
