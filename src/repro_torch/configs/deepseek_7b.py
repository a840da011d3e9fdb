"""DeepSeek-7B: llama-arch dense, MHA (kv=32).  [arXiv:2401.02954; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    num_layers=30, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=11008, vocab_size=102400, head_dim=128,
    attention="full", rope_theta=10_000.0,
    paper_ref="arXiv:2401.02954",
)
