"""zamba2-1.2b [hybrid]: 38 Mamba2 layers, d_model 2048, and ONE shared
attention + MLP block (32 heads of 64, d_ff 8192) applied after every 6th
layer; vocab 32000, ssm_state 64 (arXiv:2411.15242)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=32000, head_dim=64, ssm_state=64, ssm_expand=2,
    ssm_head_dim=64, shared_attn_every=6, shared_d_ff=8192,
    source="arXiv:2411.15242")
