"""stablelm-3b [dense]: 32L d_model=2560 32H (MHA kv=32) d_ff=6912
vocab=50304 [hf:stabilityai]."""
from repro_torch.models.transformer import ModelConfig

ARCH = "stablelm-3b"


def config(**overrides) -> ModelConfig:
    base = dict(
        name=ARCH, family="dense",
        n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=6912,
        vocab_size=50304, head_dim=80, rope_theta=10000.0,
        param_dtype="bfloat16", compute_dtype="bfloat16", remat="block",
    )
    base.update(overrides)
    return ModelConfig(**base)


def smoke() -> ModelConfig:
    return config(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                  vocab_size=128, head_dim=16, param_dtype="float32",
                  compute_dtype="float32", remat="none")
