"""Per-(arch, shape) performance presets: the JAX package's
``configs/perf_presets.py``.

The baseline dry run (``launch/dryrun.py``) runs every cell with the
generic sharding rules; ``dryrun --optimized`` applies these presets with
``dataclasses.replace``, keyed by the architecture and the shape's kind,
the same fields for the same cells as the JAX package.  They depend on the
job's kind: ``fsdp_only`` needs the global batch to cover the whole mesh
(train_4k's 256 on 256 ranks) and would be wrong for decode_32k's batch of
128.  The port reads ``rwkv_chunk``, ``rwkv_batch_parallel``,
``fsdp_only``, ``train_microbatch`` (``launch.train.mesh_train_step``),
``mla_absorb`` and ``seq_parallel_prefill``; ``flash_vjp`` is set as JAX
sets it and ignored (the port's full-causal backward is always K8).
"""
from __future__ import annotations

import dataclasses

__all__ = ["apply_preset"]

# train_4k cells whose global batch (256) covers the 16 x 16 mesh and
# whose every block weight has a dimension the whole mesh divides
_DENSE_FSDP_OK = {
    "deepseek-7b", "qwen2.5-32b", "qwen2-72b", "h2o-danube-3-4b",
    "musicgen-medium", "llava-next-34b",
}
# gradient-accumulation microbatches of the cells whose activations at
# the whole batch would not fit; not with fsdp_only, whose microbatch
# must still cover the whole mesh
_MICRO = {"qwen3-moe-235b-a22b": 8, "recurrentgemma-9b": 8,
          "deepseek-v2-lite-16b": 4}


def apply_preset(cfg, shape):
    """``cfg`` with this cell's preset applied (a new config; ``cfg`` is
    left as it was)."""
    kv = {}
    if shape.kind == "train" and cfg.mixer in ("attn", "rglru_hybrid"):
        kv["flash_vjp"] = True
    if cfg.mixer == "rwkv6" and shape.kind != "decode":
        # chunk-parallel recurrence, and the RWKV6 blocks batch-parallel
        kv["rwkv_chunk"] = 32
        kv["rwkv_batch_parallel"] = True
    if (shape.kind == "train" and cfg.name in _DENSE_FSDP_OK
            and shape.global_batch % 256 == 0):
        kv["fsdp_only"] = True
    if shape.kind == "train" and cfg.name in _MICRO \
            and not kv.get("fsdp_only"):
        kv["train_microbatch"] = _MICRO[cfg.name]
    if shape.kind == "decode" and cfg.attention == "mla":
        kv["mla_absorb"] = True  # attention in the compressed-KV space
    if (shape.kind == "prefill" and cfg.attention in ("swa", "local")
            and cfg.mixer == "attn" and shape.seq_len % 16 == 0):
        kv["seq_parallel_prefill"] = True  # context-parallel SWA prefill
    return dataclasses.replace(cfg, **kv) if kv else cfg
