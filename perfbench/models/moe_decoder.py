"""An MLA + MoE decoder configuration (DeepSeek-V3's block as Moonlight
publishes it: MLA without query LoRA, leading dense layers, sigmoid-
routed experts of which this chip holds a share, shared experts, an
untied head): its sizes read from the configuration file, and the
program's model built from them.  The reference and the weights read the
same sizes (:func:`sizes`)."""

from __future__ import annotations

import inspect


def sizes(cfg: dict) -> dict:
    """The harness's names for a configuration file's sizes (the keys of
    the published ``config.json``; ``n_routed_experts`` is the count
    held here, ``published`` the deployment's)."""
    if cfg["hidden_act"] != "silu" or cfg["scoring_func"] != "sigmoid" \
            or cfg["q_lora_rank"] is not None or cfg["n_group"] != 1 \
            or cfg["topk_group"] != 1 or not cfg["norm_topk_prob"] \
            or cfg["num_nextn_predict_layers"] != 0 \
            or cfg["moe_layer_freq"] != 1:
        raise ValueError(f"{cfg['name']}: the MoE decoder takes SiLU, "
                         "sigmoid routing over one group, renormalised "
                         "top-k, no query LoRA, no MTP, every layer after "
                         "the dense ones an MoE layer")
    held = cfg["n_routed_experts"]
    return {
        "n_layers": cfg["num_hidden_layers"],
        "n_dense_layers": cfg["first_k_dense_replace"],
        "d_model": cfg["hidden_size"],
        "n_heads": cfg["num_attention_heads"],
        "kv_lora_rank": cfg["kv_lora_rank"],
        "qk_nope_dim": cfg["qk_nope_head_dim"],
        "qk_rope_dim": cfg["qk_rope_head_dim"],
        "v_head_dim": cfg["v_head_dim"],
        "dense_ff": cfg["intermediate_size"],
        "expert_ff": cfg["moe_intermediate_size"],
        "n_experts": cfg["published"]["n_routed_experts"],
        "experts_held": (cfg["experts_held_first"], held),
        "top_k": cfg["num_experts_per_tok"],
        "n_shared": cfg["n_shared_experts"],
        "routed_scale": cfg["routed_scaling_factor"],
        "vocab": cfg["vocab_size"],
        "tie": cfg["tie_word_embeddings"],
        "rope_theta": float(cfg["rope_theta"]),
        "norm_eps": cfg["assumed"]["rms_norm_eps"],
        "dtype": cfg["torch_dtype"],
        "init_std": cfg["initializer_range"],
    }


def program_model(cfg: dict):
    """The program's ``DecoderLM`` at these sizes, its expert layer the
    dropless one over the held experts; raises where its parameter tree
    or its fixed choices differ from what the reference computes."""
    import torch
    from repro_torch.models import layers
    from repro_torch.models.mla import MLAConfig
    from repro_torch.models.moe import HeldMoEConfig
    from repro_torch.models.transformer import DecoderLM, LMConfig

    from ..moe_weights import flatten, moe_leaves

    m = sizes(cfg)
    model = DecoderLM(LMConfig(
        name=cfg["name"], n_layers=m["n_layers"], d_model=m["d_model"],
        n_heads=m["n_heads"], n_kv_heads=m["n_heads"], d_ff=m["expert_ff"],
        vocab=m["vocab"], mlp_kind="swiglu", norm_kind="rmsnorm",
        rope_theta=m["rope_theta"], tie_embeddings=m["tie"],
        param_dtype=m["dtype"],
        mla=MLAConfig(n_heads=m["n_heads"], q_lora_rank=None,
                      kv_lora_rank=m["kv_lora_rank"],
                      qk_nope_dim=m["qk_nope_dim"],
                      qk_rope_dim=m["qk_rope_dim"],
                      v_head_dim=m["v_head_dim"], rope_theta=m["rope_theta"]),
        moe=HeldMoEConfig(n_experts=m["n_experts"], top_k=m["top_k"],
                          d_ff=m["expert_ff"], n_shared=m["n_shared"],
                          router="sigmoid", routed_scale=m["routed_scale"],
                          experts_held=m["experts_held"]),
        n_dense_layers=m["n_dense_layers"], dense_d_ff=m["dense_ff"]))
    eps = inspect.signature(layers.rms_norm).parameters["eps"].default
    if eps != m["norm_eps"]:
        raise ValueError(f"the program's RMSNorm eps is {eps}, the "
                         f"configuration assumes {m['norm_eps']}")
    flat = flatten(layers.param_shapes(model))
    dtype = getattr(torch, m["dtype"])
    got = sorted((p, tuple(t.shape), t.dtype) for p, t in flat.items())
    want = sorted((p, s, torch.float32 if f32 else dtype)
                  for p, s, _, f32 in moe_leaves(m))
    if got != want:
        raise ValueError(f"the program's parameter tree {got} is not the "
                         f"one the benchmark draws: {want}")
    return model, m
