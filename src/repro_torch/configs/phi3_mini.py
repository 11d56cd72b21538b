"""phi3-mini-3.8b [dense]: RoPE SwiGLU MHA (kv=32).

32L d_model=3072 32H d_ff=8192 vocab=32064 [arXiv:2404.14219; unverified].
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    mlp_kind="swiglu",
    pos_kind="rope",
    rope_theta=10_000.0,
    norm_kind="rmsnorm",
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab_size=512, max_seq=128, flash_q_block=16, flash_kv_block=16,
    dtype="float32",
)
