"""Time the redesigned kernels against an earlier design of them on one
GPU, under both of ``chip_smoke.py``'s timing methods.

    mkdir -p build/parent
    git archive <rev> src/repro_torch/kernels | tar -x -C build/parent
    python3 scripts/kernel_timing.py \\
        --parent build/parent/src/repro_torch/kernels

``--parent`` is the ``kernels`` package of another checkout.  Its
``flash_attention.cu``, ``paged_attention.cu``, ``ssd_scan.cu`` and
``int8_quant.cu`` are built with this checkout's nvcc flags into
``build/parent_kernels/``,
and its wrappers (``ops.py``) are loaded over those libraries, so that
its host work is timed as it ran; the wrappers' own imports other than
``_build`` come from this checkout.

Attention: for every case of ``chip_smoke.KERNELS``, ``MOE_CASES`` and
``RG_CASES``, in bfloat16 and float32, both kernels are held to
``chip_smoke.TOL`` against the plain version in float32; one JSON line
gives the medians of the earlier kernel, this checkout's kernel and
(flash) SDPA.  A head width the earlier wrapper does not take (its
``HEAD_DIMS``) is timed for this checkout alone, its line saying so.  SSD: for every case
of ``chip_smoke.ssd_cases``, both kernels are held to ``1e-4 *
max|plain|``; the earlier wrapper takes the TPU layout only, so at the
grouped (serve) case it is timed on the TPU-layout copies of the same
cells (``parent``) and, as the earlier model ran it, with those copies
made in the call (``parent_with_copies``: four transposed copies and
two head repeats); the plain version is the yardstick.  int8
``quantize_rows``: at every ``[rows, cols]`` the train phase's int8 run
quantizes (``chip_smoke.int8_plan``, which includes every case of
``chip_smoke.int8_cases``), both kernels' codes and scales must equal
the plain version's; each line gives its shape's launches in that run
(``int8_plan``'s reckoning, which ``chip_smoke.py`` holds, shape by
shape, to the wrapper's own count in the int8 run) and its byte bound,
and a last line the launch-weighted device ms of both kernels over the
run and their gap to the bound.  Each time is a
``median_ms(hold=True)`` (device work alone: ``device_ms``) and
``hold=False`` (a host enqueue slower than the L2 flush counts:
``unheld_ms``), in two rounds run in opposite orders.  Needs one CUDA
device; the last line is ``{"ok": true}``.
"""

from __future__ import annotations

import argparse
import ast
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

# source -> the wrapper it exposes
WRAPPERS = {"paged_attention": "paged_attention",
            "flash_attention": "flash_attention", "ssd_scan": "ssd_chunk",
            "int8_quant": "quantize_rows"}


def parent_wrappers(kernels: Path) -> dict:
    """The earlier wrappers, each over a library built from its own
    source: all nvcc runs start together."""
    out_dir = ROOT / "build" / "parent_kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
         str(out_dir / f"lib{name}.so"), str(kernels / "csrc" / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in WRAPPERS}
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
        # relative imports other than _build resolve in this checkout
        # (the plain versions, device helpers: only impl="cuda" is timed)
        package = f"repro_torch.kernels.{name}"
        for rel, names in re.findall(r"^from (\.+[\w.]*) import (.+)$", src,
                                     re.M):
            if names.strip() == "_build":
                continue
            found = importlib.import_module(rel, package)
            for n in names.split(","):
                setattr(mod, n.strip(), getattr(found, n.strip()))
        src = re.sub(r"^from \.+[\w.]* import .+$", "", src, flags=re.M)
        exec(compile(src, str(path), "exec"), mod.__dict__)  # noqa: S102
        wrappers[name] = getattr(mod, WRAPPERS[name])
    return wrappers


def parent_head_dims(kernels: Path) -> tuple[int, ...]:
    """The head widths the earlier attention kernels take: its flash
    wrapper's ``HEAD_DIMS`` (the earlier paged wrapper imports them from
    there, which resolves in this checkout when its wrapper is loaded)."""
    src = (kernels / "flash_attention" / "ops.py").read_text()
    return ast.literal_eval(re.search(r"^HEAD_DIMS = (\(.*?\))", src,
                                      re.M).group(1))


def check(name: str, fn, args, kw, ref32, dtype) -> float:
    got = fn(*args, **kw, impl="cuda")
    torch.cuda.synchronize()
    atol, rtol = cs.TOL[dtype]
    diff = (got.float() - ref32).abs()
    if (diff - atol - rtol * ref32.abs()).max().item() > 0 \
            or not torch.isfinite(got.float()).all():
        raise RuntimeError(f"{name}: beyond atol {atol} + rtol {rtol}")
    return diff.max().item()


def check_ssd(name: str, got, want) -> float:
    """max abs error of y and the states, each within SSD_TOL x max|plain|"""
    torch.cuda.synchronize()
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        err = (g - w.reshape(g.shape)).abs().max().item()
        if err > cs.SSD_TOL * w.abs().max().item() \
                or not torch.isfinite(g).all():
            raise RuntimeError(f"{name}: beyond {cs.SSD_TOL} x max|plain|")
        worst = max(worst, err)
    return worst


def timed(calls: dict) -> dict:
    """Both methods, two rounds in opposite orders."""
    out = {}
    order = list(calls)
    for hold, key in ((True, "device_ms"), (False, "unheld_ms")):
        times = {who: [] for who in order}
        for seq in (order, order[::-1]):
            for who in seq:
                times[who].append(cs.median_ms(calls[who], hold=hold))
        out[key] = times
    return out


def to_tpu_layout(x, b, c, da, chunk):
    """The copies the earlier model made for its kernel: [B, Lp, K, d]
    cut into [B, NC, K, cs, d] contiguous, b and c repeated per head."""
    bsz, lp, h, _ = x.shape
    rep = h // b.shape[2]
    nc = lp // chunk

    def cut(t):
        return t.reshape(bsz, nc, chunk, *t.shape[2:]).transpose(2, 3) \
            .contiguous()

    return (cut(x), cut(b.repeat_interleave(rep, dim=2)),
            cut(c.repeat_interleave(rep, dim=2)),
            da.reshape(bsz, nc, chunk, h).transpose(2, 3).contiguous())


def ssd_rows(parent) -> None:
    for make in cs.ssd_cases():
        fn, args, _, _, shape = make()
        want = fn(*args, impl="ref")
        row = {"kernel": "ssd_chunk_fwd", "shape": shape}
        if fn is cs.ssd_chunk_grouped:
            tpu = to_tpu_layout(*args)
            calls = {"parent": lambda t=tpu: parent(*t, impl="cuda"),
                     "parent_with_copies": lambda: parent(
                         *to_tpu_layout(*args), impl="cuda")}
            y, s = parent(*tpu, impl="cuda")
            parent_out = (y.transpose(2, 3), s)
        else:
            calls = {"parent": lambda: parent(*args, impl="cuda")}
            parent_out = parent(*args, impl="cuda")
        calls["new"] = lambda: fn(*args, impl="cuda")
        calls["plain"] = lambda: fn(*args, impl="ref")
        row["max_abs_err"] = {
            "parent": check_ssd("ssd parent", parent_out, want),
            "new": check_ssd("ssd new", fn(*args, impl="cuda"), want)}
        cs.emit({**row, **timed(calls)})
        del args, want, calls
        cs._free()


def int8_rows(parent) -> None:
    k, where, launches = cs.int8_plan()
    what = {(r, c): w for r, c, w in cs.int8_cases(k, where)}
    gen = torch.Generator("cuda").manual_seed(8)
    total = {"parent": 0.0, "new": 0.0, "bound": 0.0}
    for (r, c), n in sorted(launches.items(), key=lambda kv: -kv[0][0]
                            * kv[0][1]):
        x = torch.randn(r, c, generator=gen, device="cuda").mul_(0.02)
        x[0] = 0.0                                   # a zero row
        want = cs.quantize_rows(x, impl="ref")
        calls = {"parent": lambda x=x: parent(x, impl="cuda"),
                 "new": lambda x=x: cs.quantize_rows(x, impl="cuda")}
        for who, call in calls.items():
            got = call()
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want, strict=True)):
                raise RuntimeError(f"quantize_rows {who} [{r}, {c}]: codes "
                                   "or scales differ from the plain version")
        b_ms, _ = cs.bound(r * c * 5 + r * 4, (5 * r * c, torch.float32))
        row = timed(calls)
        for who in ("parent", "new"):
            total[who] += n * sum(row["device_ms"][who]) / 2
        total["bound"] += n * b_ms
        cs.emit({"kernel": "quantize_rows", "shape": [r, c],
                 "what": what.get((r, c), ""), "launches": n,
                 "bound_ms": b_ms, **row})
        del x, want, calls
        cs._free()
    cs.emit({"kernel": "quantize_rows", "int8_run_launches":
             sum(launches.values()),
             "device_ms_weighted_by_launches": total,
             "gap_to_bound_ms": {who: total[who] - total["bound"]
                                 for who in ("parent", "new")}})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="the kernels package of the earlier checkout")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_timing.py needs a CUDA device")
    smi = cs.nvidia_smi()
    _build.build(tuple(WRAPPERS))
    parent = parent_wrappers(opts.parent)
    parent_widths = parent_head_dims(opts.parent)
    tiny = torch.zeros(16, device="cuda")
    floor = {"device_ms": [], "unheld_ms": []}
    for hold, key in ((True, "device_ms"), (False, "unheld_ms")):
        floor[key] = [cs.median_ms(lambda: tiny.add_(1), hold=hold)
                      for _ in range(2)]
    cs.emit({"phase": "floor", **floor})
    for name in ("paged_attention", "flash_attention"):
        new_fn = cs.KERNELS[name]["fn"]
        for geometry in (cs.KERNELS[name]["cases"] + cs.MOE_CASES[name]
                         + cs.RG_CASES[name]):
            geometry = dict(geometry)
            make = geometry.pop("case", cs.CASES[name])
            for dtype in cs.DTYPES:
                args, kw, _, _, library, shape = make(dtype, **geometry)
                ref32 = new_fn(*map(cs._f32, args), **kw, impl="ref")
                calls = {"new": lambda: new_fn(*args, **kw, impl="cuda")}
                err = {"new": check(name, new_fn, args, kw, ref32, dtype)}
                if args[0].shape[-1] in parent_widths:
                    err["parent"] = check(name, parent[name], args, kw,
                                          ref32, dtype)
                    calls["parent"] = lambda f=parent[name]: f(
                        *args, **kw, impl="cuda")
                row = {"kernel": name, "shape": shape,
                       "dtype": str(dtype).removeprefix("torch."),
                       "max_abs_err": err,
                       "parent_takes_width": "parent" in calls}
                if library is not None:
                    calls["library"] = library
                cs.emit({**row, **timed(calls)})
    ssd_rows(parent["ssd_scan"])
    int8_rows(parent["int8_quant"])
    print(smi, flush=True)
    cs.emit({"ok": True})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
