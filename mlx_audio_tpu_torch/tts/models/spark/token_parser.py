"""Spark attribute → special-token rendering (a copy of
`mlx_audio_tpu/tts/models/spark/token_parser.py`, whose package imports jax).

Behavioral spec: reference ``tts/models/spark/utils/token_parser.py`` —
the full label/token vocabulary of the StyleCraft BiCodec tokenizer
(task / age / gender / pitch / loudness / speed / emotion control
tokens). ``spark.py`` only needs the gender/pitch/speed subset for
controllable TTS; this module exposes the complete map for prompt
construction and dataset tooling parity.
"""

from __future__ import annotations

from .spark import GENDER_MAP, LEVELS_MAP

__all__ = [
    "TASK_TOKEN_MAP", "LEVELS_MAP", "LEVELS_MAP_UI", "GENDER_MAP",
    "AGE_MAP", "EMO_MAP", "TokenParser",
]

TASK_TOKEN_MAP = {
    "vc": "<|task_vc|>",
    "tts": "<|task_tts|>",
    "asr": "<|task_asr|>",
    "s2s": "<|task_s2s|>",
    "t2s": "<|task_t2s|>",
    "understand": "<|task_understand|>",
    "caption": "<|task_cap|>",
    "controllable_tts": "<|task_controllable_tts|>",
    "prompt_tts": "<|task_prompt_tts|>",
    "speech_edit": "<|task_edit|>",
}

# 1-indexed UI slider position → level name
LEVELS_MAP_UI = {i + 1: name for i, name in enumerate(LEVELS_MAP)}

AGE_MAP = {
    "Child": 0,
    "Teenager": 1,
    "Youth-Adult": 2,
    "Middle-aged": 3,
    "Elderly": 4,
}

_EMOTIONS = (
    "UNKNOWN", "NEUTRAL", "ANGRY", "HAPPY", "SAD", "FEARFUL", "DISGUSTED",
    "SURPRISED", "SARCASTIC", "EXCITED", "SLEEPY", "CONFUSED", "EMPHASIS",
    "LAUGHING", "SINGING", "WORRIED", "WHISPER", "ANXIOUS", "NO-AGREEMENT",
    "APOLOGETIC", "CONCERNED", "ENUNCIATED", "ASSERTIVE", "ENCOURAGING",
    "CONTEMPT",
)
EMO_MAP = {name: i for i, name in enumerate(_EMOTIONS)}


def _clamped(value: int, hi: int) -> int:
    return min(hi, max(0, int(value)))


class TokenParser:
    """Render labelled speaker/style attributes as control tokens."""

    @staticmethod
    def task(task: str) -> str:
        return TASK_TOKEN_MAP[task]

    @staticmethod
    def age(age: str) -> str:
        return f"<|age_{AGE_MAP[age]}|>"

    @staticmethod
    def gender(gender: str) -> str:
        return f"<|gender_{GENDER_MAP[gender]}|>"

    @staticmethod
    def emotion(emotion: str) -> str:
        return f"<|emotion_{EMO_MAP[emotion]}|>"

    @staticmethod
    def mel_value(mel: int) -> str:
        return f"<|pitch_value_{_clamped(mel, 1000)}|>"

    @staticmethod
    def mel_level(level: str) -> str:
        return f"<|pitch_label_{LEVELS_MAP[level]}|>"

    @staticmethod
    def pitch_var_value(pitch_std: int) -> str:
        return f"<|pitch_var_value_{_clamped(pitch_std, 10)}|>"

    @staticmethod
    def pitch_var_level(level: str) -> str:
        return f"<|pitch_var_label_{LEVELS_MAP[level]}|>"

    @staticmethod
    def loudness_value(loudness: int) -> str:
        return f"<|loudness_value_{_clamped(loudness, 30)}|>"

    @staticmethod
    def loudness_level(level: str) -> str:
        return f"<|loudness_label_{LEVELS_MAP[level]}|>"

    @staticmethod
    def speed_value(speed: int) -> str:
        return f"<|speed_value_{_clamped(speed, 10)}|>"

    @staticmethod
    def speed_level(level: str) -> str:
        return f"<|speed_label_{LEVELS_MAP[level]}|>"
