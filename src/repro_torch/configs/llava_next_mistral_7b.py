"""llava-next-mistral-7b [vlm]: the Mistral-7B backbone, 32 layers, d_model
4096, 32 query heads of 128 over 8 kv heads, d_ff 14336, vocab 32000, rope
theta 1e6; the vision frontend is a stub, its output given as up to 2,880
precomputed patch embeddings (anyres: 5 tiles x 576 patches) that take the
first positions (hf:llava-hf/llava-v1.6-mistral-7b-hf)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=32000, head_dim=128, rope_theta=1e6,
    n_patches=2880,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf")
