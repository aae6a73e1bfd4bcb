"""llama3.2-1b [dense]: 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256 [hf:meta-llama/Llama-3.2-1B]."""
from repro_torch.models.transformer import ModelConfig

ARCH = "llama3.2-1b"


def config(**overrides) -> ModelConfig:
    base = dict(
        name=ARCH, family="dense",
        n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, d_ff=8192,
        vocab_size=128256, head_dim=64, rope_theta=500000.0,
        tie_embeddings=True,
        param_dtype="bfloat16", compute_dtype="bfloat16", remat="block",
    )
    base.update(overrides)
    return ModelConfig(**base)


def smoke() -> ModelConfig:
    return config(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                  vocab_size=128, head_dim=16, param_dtype="float32",
                  compute_dtype="float32", remat="none")
