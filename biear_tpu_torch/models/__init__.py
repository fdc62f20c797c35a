"""Models of the port."""

from .biear import ActiveBiEAR, PassiveBiEAR, build_active, build_passive
from .config import BiEARConfig

__all__ = ["ActiveBiEAR", "BiEARConfig", "PassiveBiEAR", "build_active",
           "build_passive"]
