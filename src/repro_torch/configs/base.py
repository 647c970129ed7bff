"""Architecture and shape configuration (counterpart of
``repro/configs/base.py``, copied so the port needs nothing of the JAX
package).  ``smoke()`` derives the reduced same-family config the CPU tests
use; the full config runs on the card."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # attention flavour
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    local_global_pattern: int = 0     # 0: all-global; 2: alternate local/global
    post_norms: bool = False          # gemma2 post-attn/post-mlp norms
    embed_scale: bool = False         # gemma multiplies embeddings by sqrt(d)
    tie_embeddings: bool = True
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    router_renorm: bool = False
    capacity_factor: float = 1.25
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    conv_width: int = 4
    ssm_chunk: int = 256
    # hybrid (zamba2): shared transformer block applied every k mamba layers
    shared_attn_every: int = 0
    shared_d_ff: int = 0
    # enc-dec (whisper) and vlm stubs
    encoder_layers: int = 0
    encoder_seq: int = 0
    n_patches: int = 0
    source: str = ""

    @property
    def vocab_padded(self) -> int:
        """Embedding / LM-head rows padded to a multiple of 512; the padded
        logits are masked to -1e30."""
        return -(-self.vocab_size // 512) * 512

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def n_params(self) -> int:
        """Parameter count of a dense, MoE, pure-SSM or hybrid model, the
        families the port serves (the JAX package's formula, those branches:
        no norm weights, no qkv bias, the unpadded vocab)."""
        if self.family not in ("dense", "moe", "ssm", "hybrid"):
            raise NotImplementedError(self.family)
        d, L, hd = self.d_model, self.n_layers, self.head_dim
        attn = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d)
        if self.is_moe:     # router, routed experts, shared experts
            per = attn + d * self.n_experts + (
                self.n_experts + self.n_shared_experts) * 3 * d * self.d_ff
        elif self.family == "dense":
            per = attn + 3 * d * self.d_ff
        else:
            di, H, G, N = (self.d_inner, self.ssm_heads, self.ssm_groups,
                           self.ssm_state)
            per = (2 * d * di + 2 * d * G * N + d * H
                   + self.conv_width * (di + 2 * G * N) + di * d + di + 3 * H)
        shared = (attn + 3 * d * self.shared_d_ff
                  if self.family == "hybrid" and self.shared_attn_every else 0)
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return int(emb + L * per + shared)

    def n_active_params(self) -> int:
        """Parameters a token passes through (MoE: only its top-k routed
        experts count)."""
        if not self.is_moe:
            return self.n_params()
        inactive = (self.n_layers * (self.n_experts - self.top_k) * 3
                    * self.d_model * self.d_ff)
        return self.n_params() - int(inactive)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU tests (the JAX package's)."""
        return dataclasses.replace(
            self,
            n_layers=max(2, self.local_global_pattern or 0,
                         (self.shared_attn_every + 1) if self.shared_attn_every else 0),
            d_model=64,
            n_heads=4, n_kv_heads=(2 if self.n_kv_heads < self.n_heads else 4),
            head_dim=16,
            d_ff=128 if not self.is_moe else 32,
            shared_d_ff=128 if self.shared_d_ff else 0,
            vocab_size=503,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=32,
            sliding_window=64 if self.sliding_window else None,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=24 if self.encoder_seq else 0,
            n_patches=8 if self.n_patches else 0,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode
