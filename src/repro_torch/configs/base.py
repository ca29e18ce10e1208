"""Port of ``repro.configs.base``: the unified model configuration covering
all assigned architecture families (dense / MoE / SSM / hybrid / enc-dec /
audio / VLM) plus the pQuant paper's own model sizes.  One frozen dataclass,
field for field the JAX package's, so configs compare and hash cleanly.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.quantization import QuantConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # decoder | encdec | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- attention ---
    attn_type: str = "full"  # full | swa | mla
    window_size: int = 0  # sliding-window size when attn_type == swa
    # gemma3-style interleaving: every `global_every`-th layer is global
    # (full) attention, the rest use `window_size` local attention. 0 = off.
    global_every: int = 0
    rope_theta: float = 10000.0
    rope_theta_local: float = 10000.0  # gemma3 uses a smaller theta locally
    use_rope: bool = True
    pos_embedding: str = "rope"  # rope | learned | none

    # --- MLA (DeepSeek-V2) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- FFN ---
    glu: bool = True
    activation: str = "silu"

    # --- MoE (architecture-level, e.g. DeepSeekMoE) ---
    moe: bool = False
    n_routed_experts: int = 0
    moe_top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    first_k_dense: int = 1  # leading dense FFN layers before MoE starts
    moe_capacity_factor: float = 1.25
    # token->expert dispatch: "sort" (gather-based, FLOP-free) or "einsum"
    # (one-hot, collective-friendly — see EXPERIMENTS.md §Perf iteration B)
    moe_dispatch: str = "sort"
    moe_group_size: int = 256  # einsum dispatch group (bounds mask size)

    # --- SSM (Mamba-2 SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_groups: int = 1
    conv_kernel: int = 4

    # --- hybrid (RecurrentGemma / Griffin) ---
    block_pattern: Tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    lru_width: int = 0
    rglru_c: float = 8.0

    # --- encoder-decoder (Whisper backbone) ---
    n_enc_layers: int = 0
    n_frontend_tokens: int = 0  # encoder frames / vision patches (stub)
    frontend: str = "none"  # none | audio | vision
    # VLM: image patch tokens prepended to the text sequence
    n_image_tokens: int = 0

    # --- quantization (the paper's technique) ---
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    # pQuant decoupled-FFN dims: d_ff is the 1-bit branch width, quant.r the
    # 8-bit branch width (paper Table 1: "2272 (2400-128)").

    # --- runtime ---
    max_seq_len: int = 4096
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    tie_embeddings: bool = True
    scan_layers: bool = True
    remat: bool = True
    logit_softcap: float = 0.0  # gemma-style final-logit soft capping

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: no layer attends to unbounded context
        quadratically at prefill, or decode cost per token is O(window)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.attn_type == "swa" or self.global_every > 0

    @property
    def has_decode(self) -> bool:
        return True  # all assigned archs are decoder-bearing


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One benchmark cell: (arch x input shape)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
