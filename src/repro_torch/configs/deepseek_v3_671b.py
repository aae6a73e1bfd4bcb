"""deepseek-v3-671b [moe]: 61L d_model=7168 128H MLA, 1 shared + 256 routed
top-8 experts (d_ff_expert=2048), first 3 layers dense (d_ff=18432),
vocab=129280 [arXiv:2412.19437].

The assigned d_ff=2048 is the routed-expert width; the three leading dense
layers use DeepSeek-V3's published 18432 dense FFN. MTP head omitted
(inference-irrelevant; noted in DESIGN.md). ``mla_absorbed`` is the
beyond-paper decode optimization toggled in §Perf. The config is the
reference's; its MLA is refused under ``attn_impl="flash"`` (q and k of
192, v of 128: the kernel takes one head dim), as the reference's kernel
refuses it, so it runs the plain attention, the default.
"""
from repro_torch.models.transformer import ModelConfig

ARCH = "deepseek-v3-671b"


def config(**overrides) -> ModelConfig:
    base = dict(
        name=ARCH, family="moe",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_ff=18432,
        vocab_size=129280,
        n_experts=256, moe_top_k=8, moe_d_ff=2048, n_shared_experts=1,
        n_dense_layers=3, moe_interleave=1, capacity_factor=1.25,
        moe_token_chunks=8,  # bound [E,C,D] dispatch residency (prefill)
        use_mla=True, q_rank=1536, kv_rank=512, d_nope=128, d_rope=64, d_v=128,
        rope_theta=10000.0,
        param_dtype="bfloat16", compute_dtype="bfloat16", remat="block",
    )
    base.update(overrides)
    return ModelConfig(**base)


def smoke() -> ModelConfig:
    return config(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                  vocab_size=128, n_experts=8, moe_top_k=2, moe_d_ff=32,
                  n_dense_layers=1, q_rank=48, kv_rank=32, d_nope=16,
                  d_rope=8, d_v=16, head_dim=24, param_dtype="float32",
                  compute_dtype="float32", remat="none")
