"""zamba2-2.7b — hybrid: Mamba2 backbone + a SHARED attention+MLP block applied every
6 layers (params reused at each application, the Zamba trick). 54L d2560, attn 32H
(kv=32, head_dim 80), d_ff 10240, vocab 32000, ssm_state 64. [arXiv:2411.15242; hf]

Long-context adaptation: the shared attention uses a 4096-token sliding window for
contexts > 32k (DESIGN.md §4); <=32k stays full attention.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_kernel=4, chunk=256),
    attn_every=6,
    sliding_window_long=4096,
    source="arXiv:2411.15242; hf",
)
