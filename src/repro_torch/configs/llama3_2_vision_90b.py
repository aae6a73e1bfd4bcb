"""llama-3.2-vision-90b [vlm]: 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256; cross-attention image layers every 5th layer
[hf:meta-llama/Llama-3.2-Vision].

The vision frontend is a STUB: ``input_specs`` supplies precomputed patch
embeddings ctx [B, 1601, d_ctx] in the compute dtype; the backbone's 20
cross-attention layers attend to them.
"""
from repro_torch.models.transformer import ModelConfig

ARCH = "llama-3.2-vision-90b"


def config(**overrides) -> ModelConfig:
    base = dict(
        name=ARCH, family="vlm",
        n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
        vocab_size=128256, head_dim=128, rope_theta=500000.0,
        cross_every=5, n_ctx=1601, d_ctx=8192,
        param_dtype="bfloat16", compute_dtype="bfloat16", remat="block",
    )
    base.update(overrides)
    return ModelConfig(**base)


def smoke() -> ModelConfig:
    return config(n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                  vocab_size=128, head_dim=16, cross_every=5, n_ctx=9,
                  d_ctx=64, param_dtype="float32", compute_dtype="float32",
                  remat="none")
