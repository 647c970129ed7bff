"""gemma2-27b [dense]: 46 layers, d_model 4608, 32 query heads of 128 over 16
kv heads, d_ff 36864, vocab 256000; local (sliding window 4096) and global
layers alternate, attention softcap 50, logit softcap 30, post-norms and a
sqrt(d_model) embedding scale (arXiv:2408.00118)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, d_ff=36864,
    vocab_size=256000, head_dim=128,
    local_global_pattern=2, sliding_window=4096,
    attn_softcap=50.0, logit_softcap=30.0, post_norms=True, embed_scale=True,
    source="arXiv:2408.00118")
