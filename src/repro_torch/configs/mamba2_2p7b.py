"""mamba2-2.7b [ssm]: SSD (state-space duality), attention-free.

64L d_model=2560 ssm_state=128 expand=2 (d_inner=5120, 80 heads x 64)
vocab=50280 [arXiv:2405.21060; unverified].  O(1) decode state => runs the
long_500k cell.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=1,  # attention-free; SSD heads derive from expand*d/head_dim
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    pattern=("ssm",),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    ssm_groups=1,
    conv_width=4,
    pos_kind="none",
    norm_kind="rmsnorm",
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, vocab_size=512, ssm_state=16, ssm_head_dim=16,
    ssm_chunk=16, max_seq=128, dtype="float32",
)
