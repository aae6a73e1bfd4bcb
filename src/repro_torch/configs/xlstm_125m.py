"""xlstm-125m [ssm]: 12L d_model=768 4H vocab=50304, 1:1 mLSTM/sLSTM blocks
[arXiv:2405.04517]."""
from repro_torch.models.transformer import ModelConfig

ARCH = "xlstm-125m"


def config(**overrides) -> ModelConfig:
    base = dict(
        name=ARCH, family="ssm",
        n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_ff=0,
        vocab_size=50304,
        param_dtype="bfloat16", compute_dtype="bfloat16", remat="block",
    )
    base.update(overrides)
    return ModelConfig(**base)


def smoke() -> ModelConfig:
    return config(n_layers=4, d_model=64, n_heads=4, vocab_size=128,
                  param_dtype="float32", compute_dtype="float32",
                  remat="none")
