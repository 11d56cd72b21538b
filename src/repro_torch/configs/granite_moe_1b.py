"""granite-moe-1b-a400m [moe]: 32 experts top-8, fine-grained experts.

24L d_model=1024 16H (GQA kv=8) d_ff=512/expert vocab=49155
[hf:ibm-granite/granite-3.0-1b-a400m-base].
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    n_experts=32,
    top_k=8,
    capacity_factor=1.25,
    moe_group_size=4096,
    mlp_kind="swiglu",
    pos_kind="rope",
    rope_theta=10_000.0,
    norm_kind="rmsnorm",
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32,
    vocab_size=512, n_experts=8, top_k=2, moe_group_size=64, max_seq=128,
    flash_q_block=16, flash_kv_block=16, dtype="float32",
)
