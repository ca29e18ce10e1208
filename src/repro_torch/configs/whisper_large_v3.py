"""Port of ``repro.configs.whisper_large_v3``: the encoder-decoder audio
backbone [arXiv:2212.04356].

32 encoder + 32 decoder layers, d_model 1280, 20 heads (MHA), d_ff 5120
GELU (non-GLU), vocab 51866, learned decoder positions, sinusoidal encoder
positions.  The conv/mel frontend is a stub: the model takes 1500
precomputed frame embeddings.

The learned position table is sized to ``max_seq_len`` (32768), past
Whisper's own 448-token decoder cap.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import QuantConfig


def make(quant_mode: str = "pquant", n_experts: int = 1, r: int = 256) -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        family="encdec",
        n_layers=32,
        n_enc_layers=32,
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        d_ff=5120,
        vocab_size=51866,
        glu=False,
        activation="gelu",
        pos_embedding="learned",
        use_rope=False,
        frontend="audio",
        n_frontend_tokens=1500,
        max_seq_len=32768,
        tie_embeddings=True,
        quant=QuantConfig(mode=quant_mode, r=r, num_experts=n_experts),
    )
