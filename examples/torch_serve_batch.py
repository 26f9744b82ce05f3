"""Continuous-batching serving with the PyTorch port on a reduced config
(the counterpart of ``examples/serve_batch.py``).

Submits a mixed-length request set (short and long prompts, one
early-EOS request, one sampled request) to the ServeEngine and streams
tokens as they are generated.  On the GPU (the default) the prefill runs
the flash-attention kernel and each decode block is a CUDA graph replay.

    PYTHONPATH=src python examples/torch_serve_batch.py --arch qwen3-moe-30b-a3b
    PYTHONPATH=src python examples/torch_serve_batch.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.serve import (EngineConfig, Request, SamplingParams,
                               ServeEngine)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-moe-30b-a3b")
    ap.add_argument("--max-batch", type=int, default=2)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    arch = get_arch(args.arch)
    model = arch.make_smoke()
    params = model.init(torch.Generator(device).manual_seed(0))
    rng = np.random.RandomState(0)

    requests = [
        Request(tokens=rng.randint(0, model.cfg.vocab, size=n).tolist(),
                max_new_tokens=args.gen,
                eos_id=3 if i == 1 else None,
                sampling=(SamplingParams(temperature=0.8, top_k=40, seed=7)
                          if i == 2 else SamplingParams()))
        for i, n in enumerate((24, 8, 16, 24))]

    engine = ServeEngine(
        model, params,
        EngineConfig(max_batch=args.max_batch, max_seq=24 + args.gen),
        device=device, frontend=arch.frontend)
    for req in requests:
        engine.submit(req, on_token=lambda rid, tok, i:
                      print(f"  req {rid} token[{i}] = {tok}"))
    while engine.has_work:
        for comp in engine.step():
            print(f"done: req {comp.request_id} ({comp.finish_reason}) "
                  f"-> {comp.tokens}")

    st = engine.stats
    print(f"\n{st.requests_completed} requests, "
          f"{st.generated_tokens} tokens, "
          f"{st.decode_tokens_per_s:.1f} decode tok/s, "
          f"slot utilization {st.slot_utilization:.2f}")


if __name__ == "__main__":
    main()
