"""seamless-m4t-large-v2 [audio]: encoder-decoder backbone, 24 enc + 24 dec
layers (NLLB-1.3B-style text stack), d_model=1024 16H (kv=16) d_ff=8192
vocab=256206 [arXiv:2308.11596].

The audio frontend (w2v-BERT feature extractor) is a STUB: ``input_specs``
supplies precomputed frame embeddings [B, S/4, d_model]. Decode cells use
decoder self-KV of seq_len plus cross-KV against a 4096-frame encoder output.
"""
from repro_torch.models.transformer import ModelConfig

ARCH = "seamless-m4t-large-v2"


def config(**overrides) -> ModelConfig:
    base = dict(
        name=ARCH, family="audio",
        n_layers=48, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192,
        vocab_size=256206, head_dim=64,
        n_enc_layers=24, n_dec_layers=24, n_ctx=4096,
        param_dtype="bfloat16", compute_dtype="bfloat16", remat="block",
    )
    base.update(overrides)
    return ModelConfig(**base)


def smoke() -> ModelConfig:
    return config(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                  vocab_size=128, head_dim=16, n_enc_layers=2, n_dec_layers=2,
                  n_ctx=12, param_dtype="float32", compute_dtype="float32",
                  remat="none")
