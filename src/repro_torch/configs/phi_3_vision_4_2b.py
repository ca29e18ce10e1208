"""Port of ``repro.configs.phi_3_vision_4_2b``: the VLM backbone (phi3-mini
plus a CLIP frontend stub) [hf:microsoft/Phi-3-vision-128k-instruct].

32 layers, d_model 3072, 32 heads (MHA), d_ff 8192 SiLU-GLU, vocab 32064,
untied head.  The CLIP vision tower is a stub: a batch carries 576
precomputed patch embeddings ("image_embeds"), put before the text.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import QuantConfig


def make(quant_mode: str = "pquant", n_experts: int = 1, r: int = 384) -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b",
        family="decoder",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=32064,
        glu=True,
        activation="silu",
        rope_theta=10000.0,
        frontend="vision",
        n_image_tokens=576,
        tie_embeddings=False,
        quant=QuantConfig(mode=quant_mode, r=r, num_experts=n_experts),
    )
