"""Entry points of the LM side: ``serve`` (batched prefill + decode), run
as ``python -m repro_torch.launch.serve``."""
__all__ = ["serve"]
