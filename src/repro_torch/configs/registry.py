"""Port of ``repro.configs.registry``: ``--arch <id>`` resolution and the
reduced smoke configs.

Ported so far: the paper's own decoder family, the ``pquant-<size>``
entries (which take ``quant_mode=`` like upstream) and, as named
shorthands for the same family under another quantization mode,
``bitnet-<size>``, ``bitnet158-<size>`` and ``none-<size>``;
``deepseek-moe-16b`` and the MLA MoE ``deepseek-v2-236b``; the
sliding-window configs ``gemma3-27b`` (5 local : 1 global) and
``h2o-danube-1.8b``; the Mamba-2 SSM ``mamba2-780m``; the RG-LRU
hybrid ``recurrentgemma-2b``; the encoder-decoder ``whisper-large-v3``;
the VLM backbone ``phi-3-vision-4.2b``; and the dense code LMs
``granite-20b`` and ``deepseek-coder-33b``: every architecture of the JAX
registry.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs import (
    deepseek_coder_33b,
    deepseek_moe_16b,
    deepseek_v2_236b,
    gemma3_27b,
    granite_20b,
    h2o_danube_1_8b,
    mamba2_780m,
    phi_3_vision_4_2b,
    pquant_paper,
    recurrentgemma_2b,
    whisper_large_v3,
)
from repro_torch.configs.base import ModelConfig

ARCHS: dict[str, Callable[..., ModelConfig]] = {}
for _size in pquant_paper.SIZES:
    ARCHS[f"pquant-{_size}"] = (
        lambda _s=_size, **kw: pquant_paper.make(_s, **kw)
    )
    for _mode in ("bitnet", "bitnet158", "none"):
        ARCHS[f"{_mode}-{_size}"] = (
            lambda _s=_size, _m=_mode, **kw: pquant_paper.make(
                _s, quant_mode=_m, **kw
            )
        )
ARCHS["deepseek-moe-16b"] = deepseek_moe_16b.make
ARCHS["deepseek-v2-236b"] = deepseek_v2_236b.make
ARCHS["gemma3-27b"] = gemma3_27b.make
ARCHS["h2o-danube-1.8b"] = h2o_danube_1_8b.make
ARCHS["mamba2-780m"] = mamba2_780m.make
ARCHS["recurrentgemma-2b"] = recurrentgemma_2b.make
ARCHS["whisper-large-v3"] = whisper_large_v3.make
ARCHS["phi-3-vision-4.2b"] = phi_3_vision_4_2b.make
ARCHS["granite-20b"] = granite_20b.make
ARCHS["deepseek-coder-33b"] = deepseek_coder_33b.make

# architectures the JAX registry serves that this package has not ported:
# none is left
NOT_PORTED: tuple[str, ...] = ()


def get_config(arch: str, **kwargs) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch](**kwargs)


def reduced(cfg: ModelConfig, vocab: int = 512) -> ModelConfig:
    """Family-faithful reduced config for CPU smoke tests: few layers, small
    width, few experts, tiny vocab — all feature flags preserved."""
    d_model = 64
    n_heads = max(2, min(4, cfg.n_heads))
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    head_dim = d_model // n_heads if cfg.head_dim == cfg.d_model // cfg.n_heads else 32
    repl = dict(
        n_layers=min(cfg.n_layers, 4 if not cfg.block_pattern else len(cfg.block_pattern) + 1),
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=96 if cfg.d_ff else 0,
        vocab_size=vocab,
        max_seq_len=128,
        window_size=min(cfg.window_size, 16) if cfg.window_size else 0,
        global_every=min(cfg.global_every, 2) if cfg.global_every else 0,
        quant=dataclasses.replace(cfg.quant, r=16 if cfg.quant.r else 0),
    )
    if cfg.attn_type == "mla":
        repl.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                    qk_rope_dim=8, v_head_dim=16, head_dim=24)
    if cfg.moe:
        repl.update(n_routed_experts=8, moe_top_k=min(cfg.moe_top_k, 2),
                    n_shared_experts=min(cfg.n_shared_experts, 1), d_ff_expert=32)
    if cfg.family == "ssm":
        repl.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16,
                    n_heads=8, n_kv_heads=8, head_dim=16)
    if cfg.family == "hybrid":
        repl.update(lru_width=d_model)
    if cfg.family == "encdec":
        repl.update(n_enc_layers=2, n_frontend_tokens=12)
    if cfg.n_image_tokens:
        repl.update(n_image_tokens=8)
    return dataclasses.replace(cfg, **repl)
