"""Instruction mix of the kernels in one of the port's CUDA libraries,
read from ``cuobjdump -sass``.

    python3 scripts/sass_mix.py int8_quant --match quantize_rows

Builds ``src/repro_torch/kernels/csrc/<source>.cu`` if it is not built
yet, disassembles the library with the CUDA toolkit's ``cuobjdump`` and
prints one JSON line a kernel whose demangled name contains ``--match``:
its static instruction count and the count of each opcode (the part of
the mnemonic before its first dot), most frequent first.  Static counts
say what one pass through the code issues: an unrolled loop's body
appears once per unrolled step.  Needs the CUDA toolkit, not a GPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

# "/*0040*/  @!P0 FFMA R3, R2, R5, R4 ;" -> "FFMA"
_INSTRUCTION = re.compile(
    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")


def mix(sass: str) -> dict[str, collections.Counter]:
    """Mangled kernel name -> opcode counts, from ``cuobjdump -sass``."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = part.split("\n", 1)
        out[name.strip()] = collections.Counter(
            op.split(".")[0] for op in _INSTRUCTION.findall(body))
    return out


def demangle(names: list[str]) -> list[str]:
    cxxfilt = shutil.which("c++filt")
    if not cxxfilt:
        return names
    out = subprocess.run([cxxfilt], input="\n".join(names),
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.splitlines()
    return [n.replace("(anonymous namespace)::", "").split("(")[0]
            .removeprefix("void ") for n in out]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("source", choices=_build.SOURCES)
    ap.add_argument("--match", default="",
                    help="keep kernels whose demangled name contains this")
    opts = ap.parse_args()
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    _build.build((opts.source,))
    sass = subprocess.run([tool, "-sass", str(_build._target(opts.source))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    kernels = mix(sass)
    for name, ops in zip(demangle(list(kernels)), kernels.values(),
                         strict=True):
        if opts.match in name:
            print(json.dumps({"kernel": name,
                              "instructions": sum(ops.values()),
                              "opcodes": dict(ops.most_common())}),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
