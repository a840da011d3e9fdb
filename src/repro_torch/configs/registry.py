"""Architecture registry: full configs + reduced smoke variants."""
from __future__ import annotations

import dataclasses
import importlib

from ..models.config import ModelConfig

__all__ = ["ARCH_IDS", "get_config", "smoke_config"]

ARCH_IDS = (
    "qwen2_5_32b",
    "deepseek_7b",
    "h2o_danube3_4b",
    "qwen2_72b",
    "rwkv6_3b",
    "musicgen_medium",
    "recurrentgemma_9b",
    "deepseek_v2_lite",
    "qwen3_moe_235b",
    "llava_next_34b",
    "logreg_paper",  # the paper's own model (see configs/logreg_paper.py)
)


def get_config(name: str) -> ModelConfig:
    name = name.replace("-", "_").replace(".", "_")
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(f".{name}", __package__).CONFIG


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: small dims, few layers/experts, runnable
    on one CPU in a test.  Preserves mixer pattern / FFN kind / frontend."""
    cfg = get_config(name)
    heads = 4
    kv = 2 if cfg.num_kv_heads < cfg.num_heads else heads
    layers = 3 if cfg.mixer == "rglru_hybrid" else 2
    if cfg.moe_first_dense:
        layers = max(layers, cfg.moe_first_dense + 1)
    updates = dict(
        name=cfg.name + "_smoke",
        num_layers=layers,
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        window=min(cfg.window, 32) if cfg.window else 0,
        lru_width=64 if cfg.lru_width else 0,
        rwkv_head_dim=16,
        remat=False,
    )
    if cfg.moe_num_experts:
        updates.update(
            moe_num_experts=8, moe_top_k=2, moe_d_ff=32,
            moe_num_shared=min(cfg.moe_num_shared, 1),
            moe_dense_d_ff=128 if cfg.moe_first_dense else 0,
        )
    if cfg.attention == "mla":
        updates.update(
            mla_kv_lora=32, mla_rope_dim=8, mla_nope_dim=16, mla_v_dim=16,
            head_dim=24,  # nope + rope for q
        )
    return dataclasses.replace(cfg, **updates)
