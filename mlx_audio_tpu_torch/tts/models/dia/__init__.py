from .config import DiaConfig
from .dia import Model

__all__ = ["DiaConfig", "Model"]
