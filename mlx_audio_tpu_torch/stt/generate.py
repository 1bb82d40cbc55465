"""STT CLI: audio → transcript files (counterpart of
`mlx_audio_tpu/stt/generate.py`, with its flags).

`python -m mlx_audio_tpu_torch.stt.generate --model <dir> --audio clip.wav`

The port adds `--device` (default: the card; `cpu` runs the plain PyTorch
path) and `--dtype` (default: the checkpoint's); `--model` is a local
directory, since the port does not download.
"""

from __future__ import annotations

import argparse
import inspect
import json
import time
from typing import Optional

import torch

from ..profiling import peak_memory_gb
from .utils import load_model


def _adapt_kwargs(fn, kwargs: dict, passthrough=frozenset()) -> dict:
    """Keep only kwargs named in the callable's signature: a flag meant for
    one model family must not reach another through **kwargs (Whisper
    raises on unknown decode options). Keys in `passthrough` (the user's
    --gen-kwargs) also flow into a **kwargs sink, since the user aimed them
    at this model."""
    sig = inspect.signature(fn)
    has_var = any(p.kind == p.VAR_KEYWORD for p in sig.parameters.values())
    return {
        k: v for k, v in kwargs.items()
        if k in sig.parameters or (has_var and k in passthrough)
    }


def _stream_transcription(model, audio, verbose: bool, kwargs: dict,
                          passthrough=frozenset()):
    """Accumulate a streaming decode into one STTOutput, through the
    model's streaming entry point; partial text prints as it arrives."""
    from .models.base import STTOutput

    # models like Parakeet stream through generate(stream=True); others
    # expose a dedicated streaming method
    if "stream" in inspect.signature(model.generate).parameters:
        def stream_fn(audio, **kw):
            return model.generate(audio, stream=True, **kw)

        stream_fn.__signature__ = inspect.signature(model.generate)
    else:
        stream_fn = None
        for name in ("stream_transcribe", "stream_generate",
                     "generate_streaming"):
            if hasattr(model, name):
                stream_fn = getattr(model, name)
                break
        if stream_fn is None:
            return None

    t0 = time.perf_counter()
    segments = []
    accumulated = ""
    language = None
    prompt_tokens = 0
    generation_tokens = 0
    for result in stream_fn(audio,
                            **_adapt_kwargs(stream_fn, kwargs, passthrough)):
        txt = getattr(result, "text", "") or ""
        segments.append(
            {
                "text": txt,
                "start": getattr(result, "start_time", 0.0),
                "end": getattr(result, "end_time", 0.0),
                "is_final": getattr(result, "is_final", False),
            }
        )
        accumulated += txt
        language = getattr(result, "language", language)
        prompt_tokens = max(prompt_tokens, getattr(result, "prompt_tokens", 0))
        generation_tokens = max(
            generation_tokens, getattr(result, "generation_tokens", 0)
        )
        if verbose and txt:
            print(txt, end="", flush=True)
    if verbose:
        print()
    wall = time.perf_counter() - t0
    return STTOutput(
        text=accumulated.strip(),
        segments=segments,
        language=language,
        prompt_tokens=prompt_tokens,
        generation_tokens=generation_tokens or len(segments),
        prompt_tps=prompt_tokens / max(wall, 1e-9),
        generation_tps=(generation_tokens or len(segments)) / max(wall, 1e-9),
    )


def generate_transcription(
    model_path: str = "mlx-community/whisper-large-v3-turbo",
    audio: str = "",
    output_path: Optional[str] = None,
    format: str = "txt",
    model=None,
    verbose: bool = True,
    text: str = "",
    stream: bool = False,
    gen_kwargs: Optional[dict] = None,
    device=None,
    dtype=None,
    **kwargs,
):
    """Transcribe `audio` (a path) with the model at `model_path` (or
    `model`), print the text and write `format` files to `output_path`.
    `device` and `dtype` apply where the model is loaded here."""
    if model is None:
        model = load_model(model_path, device=device, dtype=dtype)
    passthrough = frozenset(gen_kwargs or ())
    if gen_kwargs:
        kwargs.update(gen_kwargs)
    if text:  # forced-alignment models take the text to align
        kwargs["text"] = text

    tic = time.perf_counter()
    result = None
    streamed = False
    if stream:
        result = _stream_transcription(model, audio, verbose, kwargs,
                                       passthrough)
        streamed = result is not None
        if not streamed and verbose:
            print("(model has no streaming entry point; running batch decode)")
    if result is None and kwargs.pop("chunked", False) and \
            hasattr(model, "generate_chunked"):
        # batch-parallel long-form fast path (Whisper); rolling-context
        # conditioning stays available via condition_on_previous_text,
        # decoded as a parallel fixpoint instead of a sequential loop
        call_kwargs = _adapt_kwargs(model.generate_chunked, kwargs,
                                    passthrough)
        result = model.generate_chunked(audio, **call_kwargs)
    if result is None:
        kwargs.pop("chunked", None)
        call_kwargs = _adapt_kwargs(model.generate, kwargs, passthrough)
        dropped = sorted(set(kwargs) - set(call_kwargs) - {"task"})
        if dropped and verbose:
            print(f"(options not supported by this model, ignored: {dropped})")
        result = model.generate(audio, **call_kwargs)
    wall = time.perf_counter() - tic
    if verbose:
        if not streamed:
            print(result.text)
        if result.duration:
            print(
                f"--- {result.duration:.1f}s audio in {wall:.2f}s "
                f"({result.duration / max(wall, 1e-9):.1f}x realtime), "
                f"{result.generation_tokens} tokens, "
                f"peak memory {peak_memory_gb():.3f} GB"
            )
    if output_path is not None:
        from .models.whisper.writers import get_writer

        writer = get_writer(format, output_path)
        out = writer(result, audio)
        if verbose:
            print(f"✓ wrote {out}")
    return result


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Transcribe audio to text")
    p.add_argument("--model", default="mlx-community/whisper-large-v3-turbo",
                   help="checkpoint directory")
    p.add_argument("--audio", required=True)
    p.add_argument("--output-path", default=None)
    p.add_argument("--format", default="txt",
                   choices=["txt", "srt", "vtt", "tsv", "json", "all"])
    p.add_argument("--language", default=None)
    p.add_argument("--task", default="transcribe", choices=["transcribe", "translate"])
    p.add_argument("--temperature", type=float, default=None)
    p.add_argument("--word-timestamps", action="store_true")
    p.add_argument("--max-tokens", type=int, default=None,
                   help="Maximum number of new tokens to generate")
    p.add_argument("--chunk-duration", type=float, default=None,
                   help="Chunk duration in seconds for long audio")
    p.add_argument("--frame-threshold", type=int, default=None,
                   help="AlignAtt frame threshold (streaming Whisper)")
    p.add_argument("--stream", action="store_true",
                   help="Stream the transcription as it is generated")
    p.add_argument("--chunked", action="store_true",
                   help="Batch-parallel long-form decode (Whisper): all 30s "
                        "windows in one batched program")
    p.add_argument("--condition-on-previous-text", action="store_true",
                   help="Rolling previous-text conditioning; with --chunked "
                        "it runs as a parallel fixpoint at near-chunked speed")
    p.add_argument("--context", default=None,
                   help="Context/hotwords string to guide transcription")
    p.add_argument("--prefill-step-size", type=int, default=None)
    p.add_argument("--gen-kwargs", type=json.loads, default=None,
                   help='Extra generate kwargs as JSON, e.g. \'{"top_k": 5}\'')
    p.add_argument("--text", default="",
                   help="Text to align (forced-alignment models)")
    p.add_argument("--verbose", action="store_true", default=True)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' for the plain path)")
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16", "float16"],
                   help="model dtype (default: the checkpoint's)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    kwargs = {"task": args.task}
    if args.language:
        kwargs["language"] = args.language
    if args.temperature is not None:
        kwargs["temperature"] = args.temperature
    if args.word_timestamps:
        kwargs["word_timestamps"] = True
    for name in ("max_tokens", "chunk_duration", "frame_threshold", "context",
                 "prefill_step_size"):
        v = getattr(args, name)
        if v is not None:
            kwargs[name] = v
    if args.chunked:
        kwargs["chunked"] = True
    if args.condition_on_previous_text:
        kwargs["condition_on_previous_text"] = True
    generate_transcription(
        model_path=args.model,
        audio=args.audio,
        output_path=args.output_path,
        format=args.format,
        verbose=args.verbose,
        text=args.text,
        stream=args.stream,
        gen_kwargs=args.gen_kwargs,
        device=args.device,
        dtype=getattr(torch, args.dtype) if args.dtype else None,
        **kwargs,
    )


if __name__ == "__main__":
    main()
