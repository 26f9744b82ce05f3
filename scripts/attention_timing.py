"""Time the two attention kernels against an earlier design of them on one
GPU, under both of ``chip_smoke.py``'s timing methods.

    mkdir -p build/parent
    git archive <rev> src/repro_torch/kernels | tar -x -C build/parent
    python3 scripts/attention_timing.py \\
        --parent build/parent/src/repro_torch/kernels

``--parent`` is the ``kernels`` package of another checkout.  Its
``flash_attention.cu`` and ``paged_attention.cu`` are built with this
checkout's nvcc flags into ``build/parent_kernels/``, and its wrappers
(``ops.py``) are loaded over those libraries, so that its host work is
timed as it ran.  For every attention case of ``chip_smoke.KERNELS``, in
bfloat16 and float32, both kernels are held to ``chip_smoke.TOL`` against
the plain version in float32, then one JSON line gives the medians of
the earlier kernel, this checkout's kernel and (flash) SDPA, each with
``median_ms(hold=True)`` (device work alone: ``device_ms``) and
``hold=False`` (a host enqueue slower than the L2 flush counts:
``unheld_ms``), in two rounds run in opposite orders.  Needs one CUDA
device; the last line is ``{"ok": true}``.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import re
import subprocess
import sys
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import _build  # noqa: E402

NAMES = ("paged_attention", "flash_attention")


def parent_wrappers(kernels: Path) -> dict:
    """The earlier wrappers, each over a library built from its own
    source: both nvcc runs start together."""
    out_dir = ROOT / "build" / "parent_kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
         str(out_dir / f"lib{name}.so"), str(kernels / "csrc" / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in NAMES}
    wrappers = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}.cu (parent) failed:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        path = kernels / name / "ops.py"
        src = path.read_text()
        mod = types.ModuleType(f"parent_{name}")
        mod._build = types.SimpleNamespace(library=lambda _, lib=lib: lib)
        # relative imports: the plain versions come from this checkout
        # (only impl="cuda" is timed)
        ref = importlib.import_module(f"repro_torch.kernels.{name}.ref")
        for names in re.findall(r"^from \.ref import (.+)$", src, re.M):
            for n in names.split(","):
                setattr(mod, n.strip(), getattr(ref, n.strip()))
        src = re.sub(r"^from \.+\w* import .+$", "", src, flags=re.M)
        exec(compile(src, str(path), "exec"), mod.__dict__)  # noqa: S102
        wrappers[name] = getattr(mod, name)
    return wrappers


def check(name: str, fn, args, kw, ref32, dtype) -> float:
    got = fn(*args, **kw, impl="cuda")
    torch.cuda.synchronize()
    atol, rtol = cs.TOL[dtype]
    diff = (got.float() - ref32).abs()
    if (diff - atol - rtol * ref32.abs()).max().item() > 0 \
            or not torch.isfinite(got.float()).all():
        raise RuntimeError(f"{name}: beyond atol {atol} + rtol {rtol}")
    return diff.max().item()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="the kernels package of the earlier checkout")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("attention_timing.py needs a CUDA device")
    smi = cs.nvidia_smi()
    _build.build(NAMES)
    parent = parent_wrappers(opts.parent)
    tiny = torch.zeros(16, device="cuda")
    floor = {"device_ms": [], "unheld_ms": []}
    for hold, key in ((True, "device_ms"), (False, "unheld_ms")):
        floor[key] = [cs.median_ms(lambda: tiny.add_(1), hold=hold)
                      for _ in range(2)]
    cs.emit({"phase": "floor", **floor})
    for name in NAMES:
        new_fn = cs.KERNELS[name]["fn"]
        for geometry in cs.KERNELS[name]["cases"]:
            for dtype in cs.DTYPES:
                args, kw, _, _, library, shape = \
                    cs.CASES[name](dtype, **geometry)
                ref32 = new_fn(*map(cs._f32, args), **kw, impl="ref")
                row = {"kernel": name, "shape": shape,
                       "dtype": str(dtype).removeprefix("torch."),
                       "max_abs_err": {
                           "parent": check(name, parent[name], args, kw,
                                           ref32, dtype),
                           "new": check(name, new_fn, args, kw, ref32,
                                        dtype)}}
                calls = {
                    "parent": lambda f=parent[name]: f(*args, **kw,
                                                       impl="cuda"),
                    "new": lambda: new_fn(*args, **kw, impl="cuda"),
                    "library": library}
                order = [who for who in calls if calls[who] is not None]
                for hold, key in ((True, "device_ms"), (False, "unheld_ms")):
                    times = {who: [] for who in order}
                    for seq in (order, order[::-1]):
                        for who in seq:
                            times[who].append(
                                cs.median_ms(calls[who], hold=hold))
                    row[key] = times
                cs.emit(row)
    print(smi, flush=True)
    cs.emit({"ok": True})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
