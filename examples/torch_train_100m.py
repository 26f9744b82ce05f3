"""Train a ~100M-parameter LM for a few hundred steps with the PyTorch
port (the counterpart of ``examples/train_100m.py``).

A scaled-down granite-family config (~100M params, float32) on the
synthetic Markov corpus, driven through the
:class:`repro_torch.api.Session` facade with an explicit model override
(the ``model=`` keyword replaces the arch registry lookup), AdamW through
the fused CUDA kernel on the GPU (the default), a checkpoint every 100
steps.

    PYTHONPATH=src python examples/torch_train_100m.py --steps 300
"""

import argparse

from repro_torch.api import JobConfig, Session
from repro_torch.checkpoint import CheckpointManager
from repro_torch.device import resolve_device
from repro_torch.models.transformer import DecoderLM, LMConfig

CFG_100M = LMConfig(
    name="granite-100m", n_layers=10, d_model=640, n_heads=10,
    n_kv_heads=2, d_ff=2560, vocab=8192, head_dim=64,
    tie_embeddings=True, param_dtype="float32")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--period", type=int, default=5)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch-per-worker", type=int, default=2)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt_100m_torch")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    model = DecoderLM(CFG_100M)
    print(f"params: {model.param_count() / 1e6:.1f}M")

    sess = Session(
        JobConfig(algo="dreamddp", workers=args.workers,
                  period=args.period, bandwidth=1e9, seq=args.seq,
                  batch_per_worker=args.batch_per_worker,
                  optimizer="adamw", lr=1e-3, warmup_steps=20,
                  decay_steps=args.steps, weight_decay=0.01,
                  ckpt_every=100),
        model=model,
        ckpt=CheckpointManager(args.ckpt_dir, keep=2), device=device)
    plan = sess.plan
    print("plan:", plan.meta["partition_counts"],
          "fills:", plan.meta["extra_syncs"])

    sess.fit(args.steps)
    sess.runner.ckpt.wait()
    losses = [h["loss"] for h in sess.history]
    med = sorted(h["time"] for h in sess.history)[len(losses) // 2]
    data = sess.runner.data
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(floor ~{data.entropy_floor():.3f}); {med * 1e3:.0f} ms/step; "
          f"last ckpt step {sess.runner.ckpt.latest_step()}")


if __name__ == "__main__":
    main()
