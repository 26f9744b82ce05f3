"""A dense GQA decoder configuration (SwiGLU, RMSNorm, RoPE): its sizes
read from the configuration file, and the program's model built from
them.  The reference and the weights read the same sizes
(:func:`sizes`)."""

from __future__ import annotations

import inspect


def sizes(cfg: dict) -> dict:
    """The harness's names for a configuration file's sizes (the keys of
    the published ``config.json``)."""
    if cfg["hidden_act"] != "silu":
        raise ValueError(f"{cfg['name']}: a dense decoder with SwiGLU "
                         f"takes hidden_act silu, not {cfg['hidden_act']}")
    return {
        "n_layers": cfg["num_hidden_layers"],
        "d_model": cfg["hidden_size"],
        "n_heads": cfg["num_attention_heads"],
        "n_kv_heads": cfg["num_key_value_heads"],
        "head_dim": cfg["head_dim"],
        "d_ff": cfg["intermediate_size"],
        "vocab": cfg["vocab_size"],
        "tie": cfg["tie_word_embeddings"],
        "rope_theta": cfg["rope_theta"],
        "norm_eps": cfg["assumed"]["rms_norm_eps"],
        "dtype": cfg["torch_dtype"],
        "init_std": cfg["initializer_range"],
    }


def program_model(cfg: dict):
    """The program's ``DecoderLM`` at these sizes; raises where its
    parameter tree or its fixed choices differ from what the reference
    computes."""
    import torch
    from repro_torch.models import layers
    from repro_torch.models.transformer import DecoderLM, LMConfig

    from ..weights import dense_leaves, flatten

    m = sizes(cfg)
    model = DecoderLM(LMConfig(
        name=cfg["name"], n_layers=m["n_layers"], d_model=m["d_model"],
        n_heads=m["n_heads"], n_kv_heads=m["n_kv_heads"], d_ff=m["d_ff"],
        vocab=m["vocab"], head_dim=m["head_dim"], mlp_kind="swiglu",
        norm_kind="rmsnorm", rope_theta=m["rope_theta"],
        tie_embeddings=m["tie"], param_dtype=m["dtype"]))
    eps = inspect.signature(layers.rms_norm).parameters["eps"].default
    if eps != m["norm_eps"]:
        raise ValueError(f"the program's RMSNorm eps is {eps}, the "
                         f"configuration assumes {m['norm_eps']}")
    flat = flatten(layers.param_shapes(model))
    got = sorted((p, tuple(t.shape)) for p, t in flat.items())
    want = sorted((p, s) for p, s, _ in dense_leaves(m))
    dtypes = {t.dtype for t in flat.values()}
    if got != want or dtypes != {getattr(torch, m["dtype"])}:
        raise ValueError(f"the program's parameter tree {got} {dtypes} is "
                         f"not the one the benchmark draws: {want}")
    return model, m

