"""Port of ``repro.configs.pquant_paper``: the paper's own model sizes
(Tables 1 & 4) at 300M / 700M / 1.3B / 2.6B, plus the three trained-from-scratch baselines (BitNet 1-bit, BitNet1.58
ternary, FP16 LLaMA-2-style) under identical dims.

Table 1 (pQuant):  d_ff is the 1-bit branch width, r the 8-bit width; the
sum matches the baseline FFN width so parameter budgets are matched.
NOTE 1: the paper prints "1.3B: 5076(5400-384)" whose arithmetic is
inconsistent (5400-384=5016); we keep the matched-total invariant.
NOTE 2 (TPU alignment): 5400/5016 are not divisible by the 16-way model
axis, which silently forces full FFN replication under TP; we round to
5408/5024 (+0.15% params) — same spirit as the paper's own "r restricted
to multiples of 128 for hardware efficiency" (§4.6).

2.6B layer count is not printed; 24 layers reproduces the stated 2.6B total
with d_model 2880 / d_ff 7680 (documented estimate).
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import QuantConfig

# size -> (layers, d_model, heads, baseline_d_ff, pquant_d_ff_1bit, r)
SIZES = {
    # 100m: CPU-trainable end-to-end example size (examples/train_lm.py),
    # same family/recipe as the paper's models
    "100m": (14, 768, 12, 1920, 1792, 128),
    "300m": (24, 1024, 16, 2400, 2272, 128),
    "700m": (24, 1536, 24, 4096, 3840, 256),
    "1.3b": (24, 2048, 32, 5408, 5024, 384),
    "2.6b": (24, 2880, 36, 7680, 7168, 512),
}

VOCAB = 32000  # paper: BPE tokenizer, 32K vocab
SEQ = 2048


def make(
    size: str = "1.3b",
    quant_mode: str = "pquant",
    n_experts: int = 1,
) -> ModelConfig:
    layers, d, heads, d_ff_base, d_ff_1bit, r = SIZES[size]
    is_pq = quant_mode == "pquant"
    return ModelConfig(
        name=f"pquant-{size}" if is_pq else f"{quant_mode}-{size}",
        family="decoder",
        n_layers=layers,
        d_model=d,
        n_heads=heads,
        n_kv_heads=heads,
        d_ff=d_ff_1bit if is_pq else d_ff_base,
        vocab_size=VOCAB,
        max_seq_len=SEQ,
        glu=True,
        activation="silu",
        rope_theta=10000.0,
        tie_embeddings=True,
        quant=QuantConfig(
            mode=quant_mode, r=r if is_pq else 0, num_experts=n_experts
        ),
    )
