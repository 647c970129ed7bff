"""deepseek-moe-16b [moe]: 28 layers, d_model 2048, 16 heads of 128 (kv 16),
64 fine-grained routed experts of d_ff 1408, top 6 (softmax over all, then
renormalised over the chosen), 2 shared experts, vocab 102400
(arXiv:2401.06066)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=102400, head_dim=128,
    n_experts=64, top_k=6, n_shared_experts=2, router_renorm=True,
    source="arXiv:2401.06066")
