"""qwen2-1.5b [dense] — GQA (kv=2), QKV bias. [arXiv:2407.10671]"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "qwen2-1.5b"


def config(dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab=151_936,
        act="silu", qkv_bias=True, tie_embeddings=True,
        rope_theta=1_000_000.0, dtype=dtype,
        source="arXiv:2407.10671 (Qwen2)",
    ).validate()


def reduced(dtype: str = "float32") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-reduced", family="dense",
        n_layers=2, d_model=120, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab=512,
        act="silu", qkv_bias=True, tie_embeddings=True, dtype=dtype,
        source="arXiv:2407.10671 (Qwen2)",
    ).validate()
