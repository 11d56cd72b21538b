"""Architecture configuration schema.

One ArchConfig fully describes a model in the zoo: layer pattern (attention /
sliding-window attention / Mamba-2 SSD / RG-LRU blocks), head layout, MLP/MoE
shape, positions, norms, modality frontend stubs, and the IMC execution config
(the paper's technique threaded through every matmul).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.imc_linear import DIGITAL, IMCConfig


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads

    # --- block pattern (cycled over layers) ---
    # kinds: "attn" (global), "local" (sliding window), "ssm", "rglru"
    pattern: Tuple[str, ...] = ("attn",)
    window: Optional[int] = None  # sliding-window size for "local"
    attn_softcap: Optional[float] = None  # gemma2 attention logit softcap
    final_softcap: Optional[float] = None  # gemma2 final logit softcap

    # --- mlp ---
    mlp_kind: str = "swiglu"  # swiglu | geglu | gelu
    # --- positions ---
    pos_kind: str = "rope"  # rope | learned | sinusoidal | none
    rope_theta: float = 10000.0
    max_seq: int = 32768  # learned-position table size / default cache bound

    # --- moe ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 4096

    # --- ssm (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_groups: int = 1
    conv_width: int = 4

    # --- rglru (recurrentgemma) ---
    rnn_width: int = 0
    rnn_conv_width: int = 4

    # --- norms / embeddings ---
    norm_kind: str = "rmsnorm"  # rmsnorm | layernorm
    post_norm: bool = False  # gemma2 sandwich (pre+post) norms
    tie_embeddings: bool = True
    emb_scale: bool = False  # gemma-style sqrt(d_model) embedding scale
    attn_logit_scale: Optional[float] = None  # override 1/sqrt(head_dim)

    # --- modality frontend stubs ---
    modality: str = "text"  # text | vlm | audio
    prefix_len: int = 0  # precomputed patch/frame embeddings length (vlm)

    # --- execution ---
    dtype: str = "bfloat16"
    # the execution substrate every matmul routes through: either a
    # first-class repro_torch.core.substrate.Substrate (DigitalSubstrate /
    # AnalyticIMC / BitSerialIMC - carrying calibration policy, per-site
    # overrides and the billed design point) or, for backward compatibility,
    # a bare IMCConfig (== the equivalent dynamic-policy substrate)
    imc: "IMCConfig" = DIGITAL  # IMCConfig | repro_torch.core.substrate.Substrate
    remat: bool = True  # rematerialize each block in train step
    flash_q_block: int = 512
    flash_kv_block: int = 1024
    # decode attention over the paged KV pool: "kernel" streams blocks
    # through the paged-attention kernel (repro_torch.kernels.paged_attention:
    # CUDA on the card, the identical-math plain walk on the CPU); "gather"
    # is the reference escape hatch that materializes pool[bt] each step.
    decode_attn: str = "kernel"

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows padded to a multiple of 256 so the vocab dim
        shards evenly on any mesh axis (standard framework practice; padded
        logits are masked to -inf in the head). E.g. 92553 -> 92672."""
        return -(-self.vocab_size // 256) * 256

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_per_kv(self) -> int:
        assert self.n_heads % max(self.n_kv_heads, 1) == 0
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def n_full_cycles(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def tail_kinds(self) -> Tuple[str, ...]:
        return self.pattern[: self.n_layers % len(self.pattern)]

    @property
    def is_attention_free(self) -> bool:
        return all(k == "ssm" for k in self.pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if no block attends over an unbounded range (long_500k eligible)."""
        return all(k in ("ssm", "rglru", "local") for k in self.pattern)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # parameter count (for MODEL_FLOPS = 6 N D roofline bookkeeping)
    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        emb = self.vocab_size * d  # true rows (padding excluded from N)
        total = emb if self.tie_embeddings else 2 * emb
        if self.pos_kind == "learned":
            total += self.max_seq * d
        counts = {}
        for kind in self.pattern:
            counts[kind] = counts.get(kind, 0) + self.n_full_cycles
        for kind in self.tail_kinds:
            counts[kind] += 1
        for kind, cnt in counts.items():
            if kind in ("attn", "local"):
                blk = d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
            elif kind == "ssm":
                d_in = self.ssm_expand * d
                n_h = d_in // self.ssm_head_dim
                blk = (
                    d * (2 * d_in + 2 * self.ssm_groups * self.ssm_state + n_h)
                    + d_in * d
                    + self.conv_width * (d_in + 2 * self.ssm_groups * self.ssm_state)
                )
            elif kind == "rglru":
                w = self.rnn_width
                blk = d * w * 2 + w * d + 3 * w + self.rnn_conv_width * w
            else:
                raise ValueError(kind)
            # mlp
            if self.n_experts > 0:
                e = self.top_k if active_only else self.n_experts
                if kind != "ssm":
                    mults = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
                    blk += e * mults * d * self.d_ff + d * self.n_experts
            elif self.d_ff > 0 and kind != "ssm":
                mults = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
                blk += mults * d * self.d_ff
            total += cnt * blk
        return total
