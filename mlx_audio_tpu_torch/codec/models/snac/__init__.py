from .snac import SNAC

__all__ = ["SNAC"]
