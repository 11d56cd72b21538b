"""granite-20b [dense]: gpt_bigcode-style code model.

52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152 [arXiv:2405.04324; hf].
Learned absolute positions, LayerNorm, non-gated GELU MLP.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    mlp_kind="gelu",
    pos_kind="learned",
    max_seq=32768,
    norm_kind="layernorm",
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=1, head_dim=8, d_ff=256,
    vocab_size=512, max_seq=128, flash_q_block=16, flash_kv_block=16,
    dtype="float32",
)
