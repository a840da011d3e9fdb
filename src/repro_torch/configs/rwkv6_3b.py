"""RWKV6 (Finch) 3B: attention-free, data-dependent decay.
[arXiv:2404.05892; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    num_layers=32, d_model=2560, num_heads=40, num_kv_heads=40,
    d_ff=8960, vocab_size=65536,
    attention="none", mixer="rwkv6", rwkv_head_dim=64,
    paper_ref="arXiv:2404.05892",
)
