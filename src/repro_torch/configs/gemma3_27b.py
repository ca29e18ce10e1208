"""Port of ``repro.configs.gemma3_27b``: dense LM with 5:1 local:global
attention [hf:google/gemma-3].

62L, d_model 5376, 32 heads GQA kv=16 (head_dim 128, decoupled from
d_model), d_ff 21504 GeGLU, vocab 262144.  Every 6th layer is global
attention (1M rope theta); the rest are 1024-window local (10k theta).
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import QuantConfig


def make(quant_mode: str = "pquant", n_experts: int = 1, r: int = 1024) -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b",
        family="decoder",
        n_layers=62,
        d_model=5376,
        n_heads=32,
        n_kv_heads=16,
        head_dim=128,
        d_ff=21504,
        vocab_size=262144,
        glu=True,
        activation="gelu",
        attn_type="swa",
        window_size=1024,
        global_every=6,
        rope_theta=1_000_000.0,
        rope_theta_local=10_000.0,
        tie_embeddings=True,
        quant=QuantConfig(mode=quant_mode, r=r, num_experts=n_experts),
    )
