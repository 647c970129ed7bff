"""granite-moe-1b-a400m [moe]: 24 layers, d_model 1024, 16 query heads of 64
over 8 kv heads, 32 experts of d_ff 512, top 8, vocab 49155
(hf:ibm-granite/granite-3.0-1b-a400m-base)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
    vocab_size=49155, head_dim=64,
    n_experts=32, top_k=8,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base")
