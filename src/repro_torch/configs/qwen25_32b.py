"""qwen2.5-32b [dense]: 64 layers, d_model 5120, 40 query heads over 8 kv
heads, d_ff 27648, vocab 152064, QKV bias, rope_theta 1e6, an untied LM
head (hf:Qwen/Qwen2.5-0.5B, the family)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=27648,
    vocab_size=152064, head_dim=128, qkv_bias=True, rope_theta=1e6,
    tie_embeddings=False,
    source="hf:Qwen/Qwen2.5-0.5B (family)")
