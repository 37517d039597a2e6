"""hubert-xlarge — encoder-only audio transformer (wav2vec2 arch); conv frame
frontend is a STUB (precomputed frame embeddings enter via ``embeds``).
48L d1280 16H (kv=16, head_dim 80) d_ff 5120 vocab 504 (cluster targets).
[arXiv:2106.07447; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    is_encoder=True,
    input_kind="embeds",
    source="arXiv:2106.07447; unverified",
)
