"""granite-3-8b [dense]: 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155 [hf:ibm-granite]."""
from repro_torch.models.transformer import ModelConfig

ARCH = "granite-3-8b"


def config(**overrides) -> ModelConfig:
    base = dict(
        name=ARCH, family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=12800,
        vocab_size=49155, head_dim=128, rope_theta=10000.0,
        param_dtype="bfloat16", compute_dtype="bfloat16", remat="block",
    )
    base.update(overrides)
    return ModelConfig(**base)


def smoke() -> ModelConfig:
    return config(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
                  vocab_size=128, head_dim=16, param_dtype="float32",
                  compute_dtype="float32", remat="none")
