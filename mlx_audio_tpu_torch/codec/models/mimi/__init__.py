from .mimi import Mimi, MimiConfig, MimiStreamingDecoder, mimi_202407

__all__ = ["Mimi", "MimiConfig", "MimiStreamingDecoder", "mimi_202407"]
