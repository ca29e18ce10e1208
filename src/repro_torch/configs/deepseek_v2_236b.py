"""Port of ``repro.configs.deepseek_v2_236b``: the MoE LM with Multi-head
Latent Attention [arXiv:2405.04434].

60L, d_model 5120, 128 heads MLA (q_lora 1536, kv_lora 512, qk_nope 128,
qk_rope 64, v 128), MoE: 160 routed experts top-6 + 2 shared experts,
expert d_ff 1536, first layer dense (d_ff 12288), vocab 102400 untied.
The routed experts are 1-bit; the shared-expert FFN carries the
decoupled 8-bit branch.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import QuantConfig


def make(quant_mode: str = "pquant", n_experts: int = 1, r: int = 256) -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="decoder",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        head_dim=192,  # qk_nope + qk_rope
        d_ff=12288,  # dense first layer
        vocab_size=102400,
        glu=True,
        activation="silu",
        attn_type="mla",
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        moe=True,
        n_routed_experts=160,
        moe_top_k=6,
        n_shared_experts=2,
        d_ff_expert=1536,
        first_k_dense=1,
        rope_theta=10000.0,
        tie_embeddings=False,
        quant=QuantConfig(mode=quant_mode, r=r, num_experts=n_experts),
    )
