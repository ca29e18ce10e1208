"""Port of ``repro.configs.h2o_danube_1_8b``: dense LM, llama+mistral mix
with sliding-window attention [arXiv:2401.16818].

24L, d_model 2560, 32 heads GQA kv=8, d_ff 6912 SiLU-GLU, vocab 32000,
SWA window 4096 (mistral-style).
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import QuantConfig


def make(quant_mode: str = "pquant", n_experts: int = 1, r: int = 384) -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b",
        family="decoder",
        n_layers=24,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6912,
        vocab_size=32000,
        glu=True,
        activation="silu",
        attn_type="swa",
        window_size=4096,
        rope_theta=10000.0,
        tie_embeddings=False,
        quant=QuantConfig(mode=quant_mode, r=r, num_experts=n_experts),
    )
