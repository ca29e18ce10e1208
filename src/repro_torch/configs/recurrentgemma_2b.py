"""Port of ``repro.configs.recurrentgemma_2b``: the Griffin hybrid, RG-LRU
recurrence + local attention 1:2 [arXiv:2402.19427].

26L with block pattern (rec, rec, attn), d_model 2560, 10 heads MQA kv=1
(head_dim 256), d_ff 7680 GeGLU, lru_width 2560, local window 2048,
vocab 256000.

Quantization note: RG-LRU gates and Lambda stay FP.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import QuantConfig


def make(quant_mode: str = "pquant", n_experts: int = 1, r: int = 384) -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256000,
        glu=True,
        activation="gelu",
        block_pattern=("rec", "rec", "attn"),
        lru_width=2560,
        attn_type="swa",
        window_size=2048,
        rope_theta=10000.0,
        tie_embeddings=True,
        quant=QuantConfig(mode=quant_mode, r=r, num_experts=n_experts),
    )
