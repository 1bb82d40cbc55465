"""Speech-to-speech subpackage (counterpart of `mlx_audio_tpu/sts`). Of its
families the MossFormer2-SE one is ported; its names resolve lazily, as in
the JAX package."""

_MOSS = ("MossFormer2SE", "MossFormer2SEConfig", "MossFormer2SEModel")

__all__ = list(_MOSS)


def __getattr__(name):
    if name in _MOSS:
        from .models import mossformer2_se

        return getattr(mossformer2_se, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
