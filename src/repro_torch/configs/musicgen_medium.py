"""MusicGen-medium: decoder-only over EnCodec tokens; MHA, GELU MLP.
Frontend (EnCodec codebook embedding/interleaving) is a STUB: input_specs
provides precomputed frame embeddings.  [arXiv:2306.05284; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    d_ff=6144, vocab_size=2048, head_dim=64,
    attention="full", mlp_type="gelu", frontend="embeddings",
    paper_ref="arXiv:2306.05284",
)
