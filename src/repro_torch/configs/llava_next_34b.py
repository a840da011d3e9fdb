"""LLaVA-NeXT-34B: Yi-34B-class backbone, GQA kv=8; anyres vision tiling
is a STUB (input_specs provides precomputed patch embeddings).
[hf:llava-hf/llava-v1.6-*; unverified]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=20480, vocab_size=64000, head_dim=128,
    attention="full", frontend="embeddings", rope_theta=5_000_000.0,
    paper_ref="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
