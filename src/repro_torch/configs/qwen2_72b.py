"""Qwen2-72B: dense, GQA kv=8, QKV bias.  [arXiv:2407.10671; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=29568, vocab_size=152064, head_dim=128,
    attention="full", qkv_bias=True, rope_theta=1_000_000.0,
    paper_ref="arXiv:2407.10671",
)
