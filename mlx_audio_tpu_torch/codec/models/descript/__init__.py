from .dac import DAC, DACFile

__all__ = ["DAC", "DACFile"]
