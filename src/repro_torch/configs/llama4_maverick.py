"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8),
interleaved MoE (every other layer: 128 routed experts top-1 + 1 shared),
dense layers d_ff=8192, vocab=202048 [hf:meta-llama Llama-4].

Early-fusion multimodality is out of scope for the LM backbone cells
(text-only treatment; DESIGN.md §6).
"""
from repro_torch.models.transformer import ModelConfig

ARCH = "llama4-maverick-400b-a17b"


def config(**overrides) -> ModelConfig:
    base = dict(
        name=ARCH, family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=16384,
        vocab_size=202048, head_dim=128,
        n_experts=128, moe_top_k=1, moe_d_ff=8192, n_shared_experts=1,
        moe_interleave=2, capacity_factor=1.25,
        rope_theta=500000.0,
        param_dtype="bfloat16", compute_dtype="bfloat16", remat="block",
    )
    base.update(overrides)
    return ModelConfig(**base)


def smoke() -> ModelConfig:
    return config(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                  vocab_size=128, head_dim=16, n_experts=4, moe_top_k=1,
                  moe_d_ff=64, param_dtype="float32",
                  compute_dtype="float32", remat="none")
