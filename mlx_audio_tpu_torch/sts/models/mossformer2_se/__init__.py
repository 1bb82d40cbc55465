from .config import MossFormer2SEConfig
from .model import Model, MossFormer2SEModel
from .mossformer2 import MossFormer2SE, MossFormerMaskNet, TestNet

__all__ = ["Model", "MossFormer2SE", "MossFormer2SEConfig", "MossFormer2SEModel",
           "MossFormerMaskNet", "TestNet"]
