"""Model configuration for the LM architectures.

The JAX package's ``models/config.py`` field for field, so a config built
for one package reads the same in the other; ``dtype`` is a torch dtype.
``ShapeConfig`` and ``SHAPES`` are its four dry-run shapes
(``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = ["SHAPES", "ModelConfig", "ShapeConfig", "block_kinds", "segments"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | ssm | hybrid | moe | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    attention: str = "full"  # full | swa | local | mla | none
    window: int = 0
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    mlp_type: str = "swiglu"  # swiglu | gelu
    mixer: str = "attn"  # attn | rwkv6 | rglru_hybrid
    attn_every: int = 0  # rglru_hybrid: an attention layer every N layers
    # MoE
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_num_shared: int = 0
    moe_first_dense: int = 0  # leading dense-FFN layers
    moe_dense_d_ff: int = 0
    capacity_factor: float = 1.25
    # MLA
    mla_kv_lora: int = 0
    mla_rope_dim: int = 0
    mla_nope_dim: int = 0
    mla_v_dim: int = 0
    # RWKV / RG-LRU
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 0
    # the JAX package's sharding and training knobs, kept so a config
    # carries over unchanged; the sharded program (``rules=``) reads
    # rwkv_batch_parallel, fsdp_only and seq_parallel_prefill
    rwkv_batch_parallel: bool = False
    # ignored: it picks JAX's backward for full-causal attention, which
    # in the port is always K8
    flash_vjp: bool = False
    fsdp_only: bool = False
    seq_parallel_prefill: bool = False
    train_microbatch: int = 1
    mla_absorb: bool = False
    lru_width: int = 0
    conv_width: int = 4
    # modality
    frontend: str = "tokens"  # tokens | embeddings (audio/vlm stub)
    dtype_str: str = "bfloat16"
    remat: bool = True
    paper_ref: str = ""

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype_str)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context with O(1)/O(window) state?"""
        return self.mixer != "attn" or self.attention in ("swa", "local")

    def num_params(self) -> int:
        """Total parameter count (exact, from the layer definitions)."""
        from .transformer import count_params  # lazy to avoid a cycle

        return count_params(self)

    def active_params(self) -> int:
        from .transformer import count_params

        return count_params(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One deployment shape of the dry run's cells: a global batch of
    ``global_batch`` sequences of ``seq_len`` tokens, trained
    (``train``), prefilled (``prefill``) or decoded one token against a
    cache of ``seq_len`` (``decode``)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def block_kinds(cfg: ModelConfig) -> Tuple[Tuple[str, str], ...]:
    """Per-layer (mixer_kind, ffn_kind) tuples.

    mixer_kind in {full, swa, local, mla, rwkv6, rglru};
    ffn_kind in {dense, dense_big, moe, channelmix}.
    """
    kinds = []
    for i in range(cfg.num_layers):
        if cfg.mixer == "rwkv6":
            mixer = "rwkv6"
        elif cfg.mixer == "rglru_hybrid":
            mixer = ("local" if cfg.attn_every and (i % cfg.attn_every
                     == cfg.attn_every - 1) else "rglru")
        else:
            mixer = cfg.attention
        if cfg.moe_num_experts and i >= cfg.moe_first_dense:
            ffn = "moe"
        elif cfg.moe_num_experts:
            ffn = "dense_big"
        elif cfg.mixer == "rwkv6":
            ffn = "channelmix"
        else:
            ffn = "dense"
        kinds.append((mixer, ffn))
    return tuple(kinds)


def segments(cfg: ModelConfig):
    """Group consecutive identical block kinds: [((mixer, ffn), count)].
    Each segment's parameters are stacked along a leading layer axis."""
    out = []
    for kind in block_kinds(cfg):
        if out and out[-1][0] == kind:
            out[-1][1] += 1
        else:
            out.append([kind, 1])
    return [(tuple(k), n) for k, n in out]
