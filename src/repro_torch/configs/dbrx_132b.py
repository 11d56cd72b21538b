"""dbrx-132b [moe]: 16 experts top-4, fine-grained.

40L d_model=6144 48H (GQA kv=8) d_ff=10752/expert vocab=100352
[hf:databricks/dbrx-base; unverified].
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    n_experts=16,
    top_k=4,
    capacity_factor=1.25,
    moe_group_size=4096,  # = seq-aligned groups (SSPerf dbrx iter 1: bigger
    # pools REFUTED - they break the token-sharding alignment, 2.7x worse)
    mlp_kind="swiglu",
    pos_kind="rope",
    rope_theta=500_000.0,
    norm_kind="layernorm",
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8, d_ff=48,
    vocab_size=512, n_experts=4, top_k=2, moe_group_size=64, max_seq=128,
    flash_q_block=16, flash_kv_block=16, dtype="float32",
)
