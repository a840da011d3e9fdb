"""The LM side: configuration, layers, attention, KV caches and the
decoder stack (serving path: prefill and KV-cache decode)."""
from .config import ModelConfig, block_kinds, segments
from . import attention, kvcache, layers, transformer

__all__ = ["ModelConfig", "block_kinds", "segments", "attention", "kvcache",
           "layers", "transformer"]
