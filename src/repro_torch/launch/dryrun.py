"""Production dry run: trace every (arch x shape x mesh) cell on ``meta``
tensors (``repro.launch.dryrun`` counterpart).

For each cell this writes ``<out>/<arch>__<shape>__<mesh>.json`` with the
reference's keys: ``memory_analysis`` (per-device argument, output,
alias and temporary bytes: does it fit), ``cost_analysis`` (FLOPs and
bytes of the traced step, for the roofline), ``collectives`` (per-device
wire bytes, the roofline's third term), ``meta``, ``model_flops`` and
``n_devices``, with ``trace_seconds`` for the reference's
``compile_seconds`` — and, beside it, the per-op table
``<...>.ops.json.gz`` where the reference writes ``.hlo.gz``
(:mod:`repro_torch.analysis.reanalyze` re-sums it).

The mesh is a description (:class:`~repro_torch.launch.mesh.MeshSpec`)
and every tensor is on ``meta``: no CUDA context is created and no
memory is allocated, so it runs on any machine.  Argument, output and
alias bytes are exact (specs and shard shapes); ``temp_size_in_bytes``
is an estimate: the traced program's peak of live temporaries, spread
evenly over the devices one copy of the program spans.  FLOPs and bytes
are the whole mesh's (``cost_is_per_device: false``); collectives are
reckoned from the specs and the plan, per device.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
        --shape train_4k --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import sys
import time
import traceback

__all__ = ["run_cell", "artifact", "write_artifact", "main"]


def artifact(cell, counter, out, seconds: float) -> dict:
    """One cell's artifact from its trace (``out``: the step's output;
    the reference's keys)."""
    from ..analysis.roofline import roofline_from_artifact

    costs = counter.costs
    arg, alias = cell.arg_bytes(), cell.alias_bytes()
    # the trace's peak is one copy of the program's, over the devices
    # that copy spans
    temp = counter.peak_bytes * cell.replicas // cell.n_devices
    # the aliased arguments, and the step's other outputs (logits,
    # metrics) whole on each device
    out = alias + cell.fresh_output_bytes(out)
    mem = {"argument_size_in_bytes": arg, "output_size_in_bytes": out,
           "temp_size_in_bytes": temp, "generated_code_size_in_bytes": 0,
           "alias_size_in_bytes": alias,
           "total_bytes": arg + temp + out - alias}
    art = {
        "arch": cell.arch_id, "shape": cell.shape_name,
        "mesh": cell.mesh_name, "kind": cell.kind,
        "n_devices": cell.n_devices, "model_flops": cell.model_flops,
        "cost_is_per_device": False,
        "memory_analysis": mem,
        "cost_analysis": {"flops": costs.flops,
                          "bytes accessed": costs.bytes_accessed,
                          "n_dots": costs.n_dots,
                          "unknown_loops": costs.unknown_loops},
        "collectives": cell.collectives.to_dict(),
        "kernels": {k: dict(zip(("calls", "dot_flops", "flops", "bytes"),
                                v)) for k, v in counter.kernels.items()},
        "meta": cell.meta,
        "trace_seconds": seconds,
    }
    art["roofline_h100"] = roofline_from_artifact(art).to_dict()
    return art


def write_artifact(art: dict, counter, cell, out_dir: str,
                   variant: str = "") -> str:
    """The JSON and, beside it, the gzipped per-op table."""
    os.makedirs(out_dir, exist_ok=True)
    tag = f"__{variant}" if variant else ""
    path = os.path.join(out_dir, f"{cell.arch_id}__{cell.shape_name}__"
                                 f"{cell.mesh_name}{tag}.json")
    with open(path, "w") as f:
        json.dump(art, f, indent=1)
    table = {"ops": {k: list(v) for k, v in sorted(counter.table.items())},
             "unknown_loops": counter.costs.unknown_loops,
             "collectives": _collective_rows(cell.collectives)}
    with gzip.open(path[:-5] + ".ops.json.gz", "wt") as f:
        json.dump(table, f)
    return path


def _collective_rows(summary) -> list:
    """Equal ops merged: ``[kind, result_bytes, group_size, count]``."""
    rows: dict = {}
    for o in summary.ops:
        key = (o.kind, o.result_bytes, o.group_size)
        rows[key] = rows.get(key, 0) + 1
    return [[*k, n] for k, n in rows.items()]


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool,
             out_dir: str, algo: str = "dreamddp", verbose: bool = True,
             phase: int | None = None, step_cfg=None, variant: str = "",
             **cell_kw) -> dict:
    from ..configs import SHAPES
    from .cells import build_cell
    from .mesh import make_production_mesh

    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod)
    kw = {}
    if SHAPES[shape_name].kind == "train":
        kw = {"algo": algo, "phase": phase, **cell_kw}
        if step_cfg is not None:
            kw["step_cfg"] = step_cfg
    cell = build_cell(arch_id, shape_name, mesh, multi_pod=multi_pod, **kw)
    counter, out = cell.trace()
    art = artifact(cell, counter, out, time.time() - t0)
    write_artifact(art, counter, cell, out_dir, variant)
    if verbose:
        flops = art["cost_analysis"]["flops"] / cell.n_devices
        mem = art["memory_analysis"]["total_bytes"] / 1e9
        wire = art["collectives"]["total_wire_bytes"] / 1e9
        r = art["roofline_h100"]
        print(f"  OK  {arch_id:24s} {shape_name:12s} {cell.mesh_name:10s} "
              f"flops/dev={flops:.3e} mem/dev={mem:.2f}GB "
              f"wire/dev={wire:.3f}GB h100 compute={r['compute_s']:.4g}s "
              f"memory={r['memory_s']:.4g}s "
              f"collective={r['collective_s']:.4g}s ({r['dominant']}) "
              f"[{art['trace_seconds']:.0f}s]", flush=True)
    return art


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--algo", default="dreamddp")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--variant", default="")
    ap.add_argument("--intra-worker", default="tp",
                    choices=("tp", "fsdp", "dp", "ep2"))
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    from ..configs import ARCHS, all_cells

    if args.all:
        cells = all_cells()
    else:
        if args.arch is None:
            ap.error("--arch or --all required")
        archs = [args.arch] if args.arch != "all" else list(ARCHS)
        cells = [(a, s.name) for a in archs
                 for s in ARCHS[a].shapes()
                 if args.shape in (None, s.name)]

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    for arch_id, shape_name in cells:
        for mp in meshes:
            mesh_name = "multi_pod" if mp else "single_pod"
            path = os.path.join(
                args.out, f"{arch_id}__{shape_name}__{mesh_name}.json")
            if args.skip_existing and os.path.exists(path):
                print(f"  skip {arch_id} {shape_name} {mesh_name}")
                continue
            try:
                run_cell(arch_id, shape_name, multi_pod=mp,
                         out_dir=args.out, algo=args.algo,
                         variant=args.variant,
                         intra_worker=args.intra_worker)
            except Exception:                                # noqa: BLE001
                failures.append((arch_id, shape_name, mesh_name))
                print(f"  FAIL {arch_id} {shape_name} {mesh_name}")
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} cell(s) FAILED: {failures}")
        return 1
    print("\nall requested cells traced")
    return 0


if __name__ == "__main__":
    sys.exit(main())
