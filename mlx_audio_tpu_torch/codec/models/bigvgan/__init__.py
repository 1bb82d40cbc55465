from .bigvgan import (AMPBlock1, AMPBlock2, Activation1d, BigVGAN, BigVGANConfig, Snake,
                      SnakeBeta)

__all__ = ["AMPBlock1", "AMPBlock2", "Activation1d", "BigVGAN", "BigVGANConfig", "Snake",
           "SnakeBeta"]
