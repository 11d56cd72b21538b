"""deepseek-coder-33b [dense]: llama-arch code model.

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256 [arXiv:2401.14196; hf].
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    mlp_kind="swiglu",
    pos_kind="rope",
    rope_theta=100_000.0,
    norm_kind="rmsnorm",
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8, d_ff=160,
    vocab_size=512, max_seq=128, flash_q_block=16, flash_kv_block=16,
    dtype="float32",
)
