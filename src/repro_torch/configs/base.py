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


def param_count(cfg: ModelConfig) -> dict[str, int]:
    """Approximate parameter populations by precision class, upstream's
    formula: n_1bit / n_8bit / n_fp16 and their total (embeddings, norms,
    scalars and routers stay high precision, per paper Table 3's footnote).
    n_8bit counts every expert; one of them is active a token."""
    d, h = cfg.d_model, cfg.head_dim
    nq = cfg.n_heads * h
    nkv = cfg.n_kv_heads * h
    q = cfg.quant
    quantized = q.mode in ("bitnet", "bitnet158", "pquant")

    n_1bit = n_8bit = n_fp16 = 0

    def attn_params() -> int:
        if cfg.attn_type == "mla":
            p = 0
            if cfg.q_lora_rank:
                p += d * cfg.q_lora_rank
                p += cfg.q_lora_rank * cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)
            else:
                p += d * cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)
            p += d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
            p += cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim)
            p += cfg.n_heads * cfg.v_head_dim * d
            return p
        return d * nq + 2 * d * nkv + nq * d

    def ffn_params(width: int) -> int:
        return (3 if cfg.glu else 2) * d * width

    mlp_8bit_per_layer = (3 if cfg.glu else 2) * d * q.r * q.num_experts

    for layer in range(cfg.n_layers):
        if cfg.family == "hybrid":
            blocks = [cfg.block_pattern[layer % len(cfg.block_pattern)]]
        elif cfg.family == "ssm":
            blocks = ["ssm"]
        else:
            blocks = ["attn"]

        for b in blocks:
            if b == "attn":
                ap = attn_params()
                if quantized:
                    n_1bit += ap
                else:
                    n_fp16 += ap
            elif b == "ssm":
                d_in = cfg.ssm_expand * d
                conv_dim = d_in + 2 * cfg.ssm_groups * cfg.ssm_state
                proj = d * (2 * d_in + 2 * cfg.ssm_groups * cfg.ssm_state
                            + d_in // cfg.ssm_headdim) + d_in * d
                if quantized:
                    n_1bit += proj
                else:
                    n_fp16 += proj
                n_fp16 += conv_dim * cfg.conv_kernel + 3 * (d_in // cfg.ssm_headdim)
            elif b == "rec":
                w = cfg.lru_width or d
                proj = 2 * d * w + w * d
                gates = 2 * w * w  # block-diagonal approximated dense
                if quantized:
                    n_1bit += proj
                else:
                    n_fp16 += proj
                n_fp16 += gates + w  # RG-LRU gates + Lambda stay FP
        # FFN / MoE
        if cfg.family == "ssm":
            continue  # no FFN block in mamba2
        if cfg.moe and layer >= cfg.first_k_dense:
            n_exp = cfg.n_routed_experts
            per_e = ffn_params(cfg.d_ff_expert)
            shared = cfg.n_shared_experts * ffn_params(cfg.d_ff_expert)
            if quantized:
                n_1bit += n_exp * per_e + shared
            else:
                n_fp16 += n_exp * per_e + shared
            if q.mode == "pquant":
                n_8bit += mlp_8bit_per_layer
            n_fp16 += d * n_exp  # router
        else:
            width = cfg.d_ff
            if q.mode == "pquant":
                n_1bit += ffn_params(width)
                n_8bit += mlp_8bit_per_layer
                n_fp16 += d * q.num_experts if q.num_experts > 1 else 0
            elif q.mode in ("bitnet", "bitnet158"):
                n_1bit += ffn_params(width)
            else:
                n_fp16 += ffn_params(width)

    # encoder stack (whisper): mirror decoder-style attn+ffn
    for _ in range(cfg.n_enc_layers):
        ap = attn_params()
        fp = ffn_params(cfg.d_ff)
        if quantized:
            n_1bit += ap + fp
            if q.mode == "pquant":
                n_8bit += mlp_8bit_per_layer
        else:
            n_fp16 += ap + fp
    # cross-attention in decoder layers
    if cfg.family == "encdec":
        ca = cfg.n_layers * attn_params()
        if quantized:
            n_1bit += ca
        else:
            n_fp16 += ca

    n_fp16 += cfg.vocab_size * d  # embedding
    if not cfg.tie_embeddings:
        n_fp16 += cfg.vocab_size * d
    n_fp16 += 2 * cfg.n_layers * d  # norms

    return {"n_1bit": n_1bit, "n_8bit": n_8bit, "n_fp16": n_fp16,
            "total": n_1bit + n_8bit + n_fp16}
