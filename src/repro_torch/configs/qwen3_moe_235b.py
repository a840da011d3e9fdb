"""Qwen3-MoE-235B-A22B: GQA kv=4, 128 experts top-8.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
    d_ff=1536, vocab_size=151936, head_dim=128,
    attention="full", rope_theta=1_000_000.0,
    moe_num_experts=128, moe_top_k=8, moe_d_ff=1536,
    paper_ref="hf:Qwen/Qwen3-30B-A3B",
)
