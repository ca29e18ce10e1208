"""Port of ``repro.configs.deepseek_coder_33b``: the dense code LM, llama
architecture [arXiv:2401.14196].

62 layers, d_model 7168, 56 heads over 8 KV heads (GQA), d_ff 19200
SiLU-GLU, vocab 32256, untied head, rope theta 100k.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import QuantConfig


def make(quant_mode: str = "pquant", n_experts: int = 1, r: int = 1024) -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b",
        family="decoder",
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=19200,
        vocab_size=32256,
        glu=True,
        activation="silu",
        rope_theta=100_000.0,
        tie_embeddings=False,
        quant=QuantConfig(mode=quant_mode, r=r, num_experts=n_experts),
    )
