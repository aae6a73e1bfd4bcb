"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention blocks.

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64
[arXiv:2411.15242]. The shared transformer block (one weight set) is applied
after every 6 Mamba2 blocks (6 applications + 2 trailing Mamba blocks);
Zamba2's per-application LoRA adapters and embedding-concat input are
simplified away, as in the reference's config.
"""
from repro_torch.models.transformer import ModelConfig

ARCH = "zamba2-1.2b"


def config(**overrides) -> ModelConfig:
    base = dict(
        name=ARCH, family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
        vocab_size=32000, head_dim=64,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2, d_conv=4,
        attn_every=6, ssd_chunk=128,
        param_dtype="bfloat16", compute_dtype="bfloat16", remat="block",
    )
    base.update(overrides)
    return ModelConfig(**base)


def smoke() -> ModelConfig:
    return config(n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                  vocab_size=128, head_dim=16, ssm_state=16, ssm_head_dim=16,
                  attn_every=2, ssd_chunk=8, param_dtype="float32",
                  compute_dtype="float32", remat="none")
