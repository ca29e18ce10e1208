"""Port of ``repro.configs.mamba2_780m``: the attention-free SSM with
state-space duality [arXiv:2405.21060].

48L, d_model 1536, expand 2 (d_inner 3072), headdim 64 (48 SSD heads),
state 128, 1 group, conv kernel 4, vocab 50280.  No FFN / no attention.

pQuant adaptation: the in/out projections use the decoupled *projection*
(1-bit dominant + r-wide 8-bit bottleneck); SSD/conv/gate parameters stay
FP.  Decode keeps a constant-size state.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import QuantConfig


def make(quant_mode: str = "pquant", n_experts: int = 1, r: int = 128) -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m",
        family="ssm",
        n_layers=48,
        d_model=1536,
        n_heads=48,  # SSD heads (d_inner / headdim)
        n_kv_heads=48,
        head_dim=64,
        d_ff=0,
        vocab_size=50280,
        glu=False,
        ssm_state=128,
        ssm_headdim=64,
        ssm_expand=2,
        ssm_chunk=256,
        ssm_groups=1,
        conv_kernel=4,
        tie_embeddings=True,
        quant=QuantConfig(mode=quant_mode, r=r, num_experts=n_experts),
    )
