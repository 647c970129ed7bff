"""whisper-medium [audio]: an encoder-decoder of 24 + 24 layers, d_model
1024, 16 heads of 64, d_ff 4096, vocab 51865; the conv/mel frontend is a
stub, its output given as 1,500 precomputed frame embeddings
(arXiv:2212.04356)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab_size=51865, head_dim=64, encoder_layers=24, encoder_seq=1500,
    source="arXiv:2212.04356")
