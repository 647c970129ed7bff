"""mamba2-780m [ssm]: 48 Mamba2 layers, d_model 1536 (no attention), 48 SSM
heads of 64, ssm_state 128, vocab 50280 padded to 50688 (arXiv:2405.21060)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50280, ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    source="arXiv:2405.21060")
