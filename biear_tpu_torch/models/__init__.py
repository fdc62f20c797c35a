"""Models of the port."""

from .auralnet import AuralNet, build_auralnet
from .biear import ActiveBiEAR, PassiveBiEAR, build_active, build_passive
from .config import BiEARConfig

__all__ = ["ActiveBiEAR", "AuralNet", "BiEARConfig", "PassiveBiEAR",
           "build_active", "build_auralnet", "build_passive"]
