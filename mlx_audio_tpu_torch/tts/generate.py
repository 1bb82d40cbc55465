"""TTS CLI: text → audio files (counterpart of `mlx_audio_tpu/tts/generate.py`,
with its flags).

`python -m mlx_audio_tpu_torch.tts.generate --model <dir> --text "..."`

The port adds `--device` (default: the card; `cpu` runs the plain PyTorch
path) and `--dtype` (default: the checkpoint's); `--model` is a local
directory, since the port does not download. `--play` plays through
`sounddevice` (`audio_player.py`) and raises where it or an output device is
missing.
"""

from __future__ import annotations

import argparse
import inspect
import sys
from pathlib import Path
from typing import Optional

import numpy as np

import torch

from .. import audio_io
from ..utils import load_audio  # noqa: F401  (public re-export, as in the JAX package)
from .utils import load_model


def detect_speech_boundaries(
    wav: np.ndarray,
    sample_rate: int,
    window_duration: float = 0.1,
    energy_threshold: float = 0.01,
    margin_factor: int = 2,
):
    """Start and end sample indices of speech by windowed RMS energy;
    ValueError when the audio is all silence."""
    wav = np.asarray(wav, dtype=np.float32).reshape(-1)
    window_size = max(1, int(window_duration * sample_rate))
    margin = margin_factor * window_size
    step_size = max(1, window_size // 10)
    if wav.size < window_size:
        windows = wav[None, :]
    else:
        windows = np.lib.stride_tricks.sliding_window_view(wav, window_size)[
            ::step_size
        ]
    energy = np.sqrt(np.mean(windows**2, axis=1))
    speech_mask = energy >= energy_threshold
    if not np.any(speech_mask):
        raise ValueError("No speech detected in audio (only silence)")
    start = max(0, int(np.argmax(speech_mask)) * step_size - margin)
    end = min(
        len(wav),
        (len(speech_mask) - 1 - int(np.argmax(speech_mask[::-1]))) * step_size
        + margin,
    )
    return start, end


def remove_silence_on_both_ends(
    wav: np.ndarray,
    sample_rate: int,
    window_duration: float = 0.1,
    volume_threshold: float = 0.01,
) -> np.ndarray:
    """Trim leading and trailing silence."""
    start, end = detect_speech_boundaries(
        wav, sample_rate, window_duration, volume_threshold
    )
    return np.asarray(wav).reshape(-1)[start:end]


def hertz_to_mel(pitch):
    """Hz → mel scale."""
    return 2595 * np.log10(1 + np.asarray(pitch, dtype=np.float64) / 700)


def generate_audio(
    text: str,
    model_path: str = "prince-canuma/Kokoro-82M",
    model=None,
    voice: Optional[str] = None,
    speed: float = 1.0,
    lang_code: str = "a",
    file_prefix: str = "audio",
    audio_format: str = "wav",
    sample_rate: Optional[int] = None,
    join_audio: bool = False,
    verbose: bool = True,
    ref_audio: Optional[str] = None,
    ref_text: Optional[str] = None,
    stream: bool = False,
    play: bool = False,
    output_path: str = ".",
    device=None,
    dtype=None,
    **kwargs,
):
    """Generate speech, write wav/other files, return the results list.
    `device` and `dtype` apply where a model is loaded here."""
    if play:
        from .audio_player import check_output_device

        check_output_device()
    if model is None:
        model = load_model(model_path, device=device, dtype=dtype)

    # keep to the arguments the model's generate takes
    sig = inspect.signature(model.generate)
    accepted = set(sig.parameters)

    # Voice cloning without a transcript: auto-transcribe the reference
    # audio with an STT model
    if (
        ref_audio is not None and ref_text is None
        and "ref_text" in accepted
    ):
        stt_model = kwargs.pop("stt_model", None)
        stt_path = kwargs.pop(
            "stt_model_path", "mlx-community/whisper-large-v3-turbo"
        )
        try:
            if stt_model is None:
                from ..utils import load_model as _load_any

                stt_model = _load_any(stt_path, device=device)
            from ..utils import load_audio as _load_audio

            wav = _load_audio(ref_audio, sample_rate=16000)
            ref_text = stt_model.generate(wav).text
            if verbose:
                print(f"auto-transcribed ref audio: {ref_text!r}")
        except Exception as e:
            if verbose:
                print(f"ref-audio transcription failed ({e}); "
                      "continuing without ref_text")
    call_kwargs = dict(text=text, **kwargs)
    for k, v in [
        ("voice", voice), ("speed", speed), ("lang_code", lang_code),
        ("ref_audio", ref_audio), ("ref_text", ref_text), ("stream", stream),
        ("verbose", verbose),
    ]:
        if k in accepted and v is not None:
            call_kwargs[k] = v
    call_kwargs = {
        k: v for k, v in call_kwargs.items()
        if k in accepted or "kwargs" in str(sig)
    }

    results = []
    segments = []
    player = None
    out_dir = Path(output_path)
    out_dir.mkdir(parents=True, exist_ok=True)
    for result in model.generate(**call_kwargs):
        results.append(result)
        audio = np.asarray(result.audio).reshape(-1)
        sr = sample_rate or result.sample_rate
        if play:
            if player is None:
                from .audio_player import AudioPlayer

                player = AudioPlayer(sample_rate=sr, verbose=verbose)
            player.queue_audio(audio)
        if join_audio:
            segments.append(audio)
        else:
            fname = out_dir / f"{file_prefix}_{result.segment_idx:03d}.{audio_format}"
            audio_io.write(fname, audio, sr)
            if verbose:
                print(f"✓ wrote {fname}")
        if verbose:
            print(
                f"segment {result.segment_idx}: {result.audio_duration} "
                f"rtf={result.real_time_factor:.3f} "
                f"({result.processing_time_seconds:.2f}s)"
            )
    if join_audio and segments:
        sr = sample_rate or results[0].sample_rate
        fname = out_dir / f"{file_prefix}.{audio_format}"
        audio_io.write(fname, np.concatenate(segments), sr)
        if verbose:
            print(f"✓ wrote {fname}")
    if player is not None:
        # a short clip may not reach the auto-play buffer threshold: start
        # playback explicitly before draining
        player.play()
        if player.playing:
            player.wait_for_drain(timeout=120)
        player.stop()
    return results


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Generate speech from text")
    p.add_argument("--model", default="prince-canuma/Kokoro-82M", help="checkpoint directory")
    p.add_argument("--text", default=None)
    p.add_argument("--voice", default=None)
    p.add_argument("--speed", type=float, default=1.0)
    p.add_argument("--lang_code", default="a")
    p.add_argument("--file_prefix", default="audio")
    p.add_argument("--audio_format", default="wav")
    p.add_argument("--sample_rate", type=int, default=None)
    p.add_argument("--join_audio", action="store_true")
    p.add_argument("--output_path", default=".")
    p.add_argument("--ref_audio", default=None)
    p.add_argument("--ref_text", default=None)
    p.add_argument("--stt_model", default=None,
                   help="STT model used to auto-transcribe --ref_audio")
    p.add_argument("--play", action="store_true",
                   help="Play the generated audio (not ported: raises)")
    p.add_argument("--stream", action="store_true",
                   help="Request streaming generation from the model")
    p.add_argument("--max_tokens", type=int, default=None)
    p.add_argument("--temperature", type=float, default=None)
    p.add_argument("--top_p", type=float, default=None)
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--repetition_penalty", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--instruct", default=None,
                   help="Instruction text (CosyVoice instruct / VoiceDesign)")
    p.add_argument("--exaggeration", type=float, default=None,
                   help="Chatterbox emotion exaggeration")
    p.add_argument("--cfg_scale", type=float, default=None,
                   help="Classifier-free-guidance scale (Dia, VibeVoice, ...)")
    p.add_argument("--ddpm_steps", type=int, default=None,
                   help="Diffusion steps (VibeVoice)")
    p.add_argument("--gender", default=None,
                   help="Voice gender control token (Spark)")
    p.add_argument("--pitch", type=float, default=None,
                   help="Pitch control (Spark)")
    p.add_argument("--streaming_interval", type=float, default=None,
                   help="Seconds of audio per streamed chunk")
    p.add_argument("--verbose", action="store_true", default=True)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' for the plain path)")
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16", "float16"],
                   help="model dtype (default: the checkpoint's)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    text = args.text
    if text is None:
        text = sys.stdin.read()
    kwargs = {}
    for name in ("max_tokens", "temperature", "top_p", "top_k",
                 "repetition_penalty", "seed", "instruct", "exaggeration",
                 "cfg_scale", "ddpm_steps", "gender", "pitch",
                 "streaming_interval"):
        v = getattr(args, name)
        if v is not None:
            kwargs[name] = v
    if args.stt_model is not None:
        kwargs["stt_model_path"] = args.stt_model
    generate_audio(
        text=text,
        model_path=args.model,
        voice=args.voice,
        speed=args.speed,
        lang_code=args.lang_code,
        file_prefix=args.file_prefix,
        audio_format=args.audio_format,
        sample_rate=args.sample_rate,
        join_audio=args.join_audio,
        output_path=args.output_path,
        ref_audio=args.ref_audio,
        ref_text=args.ref_text,
        stream=args.stream,
        play=args.play,
        device=args.device,
        dtype=getattr(torch, args.dtype) if args.dtype else None,
        **kwargs,
    )


if __name__ == "__main__":
    main()
