"""Optimizers for the LM training path: AdamW and gradient compression."""
from .adamw import AdamWConfig, AdamWState, adamw_init, adamw_update
from .compression import init_error_feedback

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "init_error_feedback"]
