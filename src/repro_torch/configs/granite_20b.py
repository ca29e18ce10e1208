"""Port of ``repro.configs.granite_20b``: the dense code LM
[arXiv:2405.04324].

52 layers, d_model 6144, 48 heads over one KV head (MQA), d_ff 24576 (4x,
plain MLP with GELU), vocab 49152, tied embedding.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import QuantConfig


def make(quant_mode: str = "pquant", n_experts: int = 1, r: int = 1280) -> ModelConfig:
    return ModelConfig(
        name="granite-20b",
        family="decoder",
        n_layers=52,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        d_ff=24576,
        vocab_size=49152,
        glu=False,
        activation="gelu",
        rope_theta=10000.0,
        tie_embeddings=True,
        quant=QuantConfig(mode=quant_mode, r=r, num_experts=n_experts),
    )
