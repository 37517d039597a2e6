"""llava-next-34b — VLM; anyres-tiled vision frontend is a STUB (precomputed patch
embeddings enter via ``embeds``). Backbone per assignment: 60L d7168 56H (GQA kv=8)
d_ff 20480 vocab 64000. [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    input_kind="embeds",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)
