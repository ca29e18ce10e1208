"""Port of ``repro.configs.deepseek_moe_16b``: the fine-grained MoE LM
[arXiv:2401.06066].

28L, d_model 2048, 16 heads (MHA), 64 routed experts top-6 + 2 shared,
expert d_ff 1408, first layer dense (d_ff 10944), vocab 102400 untied.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import QuantConfig


def make(quant_mode: str = "pquant", n_experts: int = 1, r: int = 128) -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="decoder",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=10944,  # dense first layer
        vocab_size=102400,
        glu=True,
        activation="silu",
        moe=True,
        n_routed_experts=64,
        moe_top_k=6,
        n_shared_experts=2,
        d_ff_expert=1408,
        first_k_dense=1,
        rope_theta=10000.0,
        tie_embeddings=False,
        quant=QuantConfig(mode=quant_mode, r=r, num_experts=n_experts),
    )
