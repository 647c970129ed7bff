"""glm4-9b [dense]: 40 layers, d_model 4096, 32 query heads over 2 kv heads
(GQA 16), d_ff 13696, vocab 151552, RoPE (hf:THUDM/glm-4-9b)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab_size=151552, head_dim=128,
    source="hf:THUDM/glm-4-9b")
