"""mamba2-130m — attention-free SSM with SSD (state-space duality).
24L d768, ssm_state 128, vocab 50280. [arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_kernel=4, chunk=256),
    source="arXiv:2405.21060; unverified",
)
