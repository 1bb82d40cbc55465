from .cache import KVCache

__all__ = ["KVCache"]
