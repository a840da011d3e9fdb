"""RecurrentGemma-9B (Griffin): RG-LRU + local attention 2:1, MQA kv=1.
[arXiv:2402.19427; unverified]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    d_ff=12288, vocab_size=256000, head_dim=256,
    attention="local", window=2048, mixer="rglru_hybrid", attn_every=3,
    lru_width=4096, conv_width=4,
    paper_ref="arXiv:2402.19427",
)
