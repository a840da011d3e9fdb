"""DeepSeek-V2-Lite 16B: MLA (kv_lora=512, rope 64) + MoE 64 routed top-6,
2 shared experts, first layer dense.  [arXiv:2405.04434; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    attention="mla", mla_kv_lora=512, mla_rope_dim=64, mla_nope_dim=128,
    mla_v_dim=128, head_dim=192,
    moe_num_experts=64, moe_top_k=6, moe_d_ff=1408, moe_num_shared=2,
    moe_first_dense=1, moe_dense_d_ff=10944,
    paper_ref="arXiv:2405.04434",
)
