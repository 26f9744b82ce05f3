"""Serving CLI: the continuous-batching engine on the GPU.

Counterpart of ``repro.launch.serve`` with the same flags plus
``--device``.  Weights are random, made from a seeded
``torch.Generator`` on the device; prompts come from
``numpy.random.RandomState(1)`` as in the reference CLI.

Synthetic workload (uniform batch)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
        --kv-backend paged --batch 8 --prompt-len 256 --gen 32

Mamba-2 (``--arch mamba2-780m``) and the Griffin hybrid (``--arch
recurrentgemma-9b``) run on the contiguous backend, the default;
``--kv-backend paged`` is refused with the engine's error (their lanes
are fixed conv windows and recurrent states, and Griffin's attention a
ring of ``window`` keys).  On the CPU::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
        --smoke --device cpu --batch 3 --prompt-len 20 --gen 5
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-9b --smoke --device cpu --batch 3 \\
        --prompt-len 12 --gen 10

Trace-driven mode — ``--requests`` takes a JSON file with a list of
request dicts (``tokens`` or ``prompt_len``, ``max_new_tokens``, optional
``eos_id`` / ``temperature`` / ``top_k`` / ``seed``).  ``--smoke`` runs
the reduced config; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def _load_trace(path: str, vocab: int, rng) -> list[dict]:
    with open(path) as f:
        trace = json.load(f)
    if not isinstance(trace, list):
        raise ValueError(f"{path}: expected a JSON list of request dicts")
    for r in trace:
        if "tokens" not in r:
            n = int(r.get("prompt_len", 8))
            r["tokens"] = rng.randint(0, vocab, size=n).tolist()
        _ = r.setdefault("max_new_tokens", 16)
    return trace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="synthetic mode: number of requests")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--requests", default=None,
                    help="JSON trace file (list of request dicts)")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="engine slot count (default: --batch)")
    ap.add_argument("--max-seq", type=int, default=None)
    ap.add_argument("--decode-block", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=None)
    ap.add_argument("--kv-backend", default="contiguous",
                    choices=("contiguous", "paged"))
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (paged backend)")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="pool pages incl. trash page (default: worst "
                         "case); smaller pools defer admission")
    ap.add_argument("--serial-admission", action="store_true",
                    help="one prefill + one sync per request (identical "
                         "greedy tokens to the batched default)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run "
                         "on the CPU)")
    args = ap.parse_args(argv)

    import torch

    from ..configs import get_arch
    from ..device import resolve_device
    from ..serve import EngineConfig, Request, SamplingParams, ServeEngine

    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    model = arch.make_smoke() if args.smoke else arch.make_model()
    cfg = model.cfg
    params = model.init(torch.Generator(device=device).manual_seed(0))
    rng = np.random.RandomState(1)

    if args.requests:
        trace = _load_trace(args.requests, cfg.vocab, rng)
    else:
        trace = [{"tokens": rng.randint(0, cfg.vocab,
                                        size=args.prompt_len).tolist(),
                  "max_new_tokens": args.gen}
                 for _ in range(args.batch)]
    requests = [
        Request(tokens=r["tokens"],
                max_new_tokens=int(r["max_new_tokens"]),
                eos_id=r.get("eos_id"),
                sampling=SamplingParams(
                    temperature=float(r.get("temperature", 0.0)),
                    top_k=int(r.get("top_k", 0)),
                    seed=int(r.get("seed", 0))))
        for r in trace]

    max_seq = args.max_seq or max(len(r.tokens) + r.max_new_tokens
                                  for r in requests)
    if args.kv_backend == "paged":       # pages divide the lane evenly
        max_seq += (-max_seq) % args.page_size
    engine = ServeEngine(
        model, params,
        EngineConfig(max_batch=args.max_batch or args.batch,
                     max_seq=max_seq,
                     decode_block=args.decode_block,
                     prefill_chunk=args.prefill_chunk,
                     kv_backend=args.kv_backend,
                     page_size=args.page_size,
                     kv_pages=args.kv_pages,
                     batched_admission=not args.serial_admission),
        device=device)

    completions = engine.generate(requests)
    engine.take_completed()     # drain the bounded completion history
    st = engine.stats
    n_dec = st.decode_tokens
    ms_tok = (st.decode_time_s / n_dec * 1e3) if n_dec else 0.0
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"arch={args.arch} device={name} requests={st.requests_completed} "
          f"prompt_tokens={st.prompt_tokens} "
          f"generated={st.generated_tokens}")
    print(f"prefill={st.prefill_time_s * 1e3:.1f}ms "
          f"({st.prefill_batches} batched prefills / {st.admit_ticks} "
          f"admit ticks)  "
          f"decode {n_dec} steps={st.decode_time_s * 1e3:.1f}ms "
          f"({ms_tok:.1f} ms/tok, {st.decode_tokens_per_s:.1f} tok/s)")
    print(f"ttft mean={st.mean_ttft_s * 1e3:.1f}ms  "
          f"latency mean={st.mean_latency_s * 1e3:.1f}ms  "
          f"slot_util={st.slot_utilization:.2f}")
    print("generated:", completions[0].tokens[:12])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
