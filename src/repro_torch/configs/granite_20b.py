"""granite-20b [dense]: 52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152, code model [arXiv:2405.04324]."""
from repro_torch.models.transformer import ModelConfig

ARCH = "granite-20b"


def config(**overrides) -> ModelConfig:
    base = dict(
        name=ARCH, family="dense",
        n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
        vocab_size=49152, head_dim=128, rope_theta=10000.0,
        mlp_type="gelu",  # gpt_bigcode-style 2-matrix MLP
        param_dtype="bfloat16", compute_dtype="bfloat16", remat="block",
    )
    base.update(overrides)
    return ModelConfig(**base)


def smoke() -> ModelConfig:
    return config(n_layers=4, d_model=64, n_heads=4, n_kv_heads=1, d_ff=256,
                  vocab_size=128, head_dim=16, param_dtype="float32",
                  compute_dtype="float32", remat="none")
