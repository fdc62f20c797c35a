"""Models of the port."""

from .biear import ActiveBiEAR, build_active
from .config import BiEARConfig

__all__ = ["ActiveBiEAR", "BiEARConfig", "build_active"]
