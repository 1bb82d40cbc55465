"""Shared config base: dataclass-from-dict with unknown-key filtering
(counterpart of `mlx_audio_tpu/base.py`)."""

from __future__ import annotations

import inspect
from dataclasses import dataclass

__all__ = ["BaseModelArgs"]


@dataclass
class BaseModelArgs:
    @classmethod
    def from_dict(cls, params: dict):
        return cls(
            **{
                k: v
                for k, v in params.items()
                if k in inspect.signature(cls).parameters
            }
        )
