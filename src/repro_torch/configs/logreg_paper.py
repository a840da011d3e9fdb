"""The paper's own model: L2-regularized logistic regression.

Not a transformer: kept in the registry so it names every architecture
the JAX package does.  The port fits it through ``core`` (``secure_fit``).
"""
from ..models.config import ModelConfig

# Encoded as a degenerate ModelConfig for registry uniformity; the logreg
# driver reads d (features) from the dataset, not from here.
CONFIG = ModelConfig(
    name="logreg-paper", family="logreg",
    num_layers=0, d_model=84, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=2, attention="none",
    paper_ref="DOI 10.1371/journal.pone.0156479",
)
