"""The LM architectures' configurations, one data file each, as in the JAX
package's ``configs/``."""
from .registry import ARCH_IDS, get_config, smoke_config

__all__ = ["ARCH_IDS", "get_config", "smoke_config"]
