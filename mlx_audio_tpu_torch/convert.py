"""Checkpoint conversion: quantize, dequantize, dtype cast (counterpart of
`mlx_audio_tpu/convert.py`).

The JAX package's converter on local paths: domain detection, dtype cast,
4/6/8-bit affine quantization (the packed uint32 / uint8 words of
`nn.quantized`, bit for bit the JAX package's) with group size and mixed
recipes, dequantization, sharded safetensors with an index, and the model
card. bfloat16 is written through the port's safetensors writer, without
`ml_dtypes`. A hub id and `upload_repo` raise: the port does not download
or upload.

Usage:
    python -m mlx_audio_tpu_torch.convert --model <dir> -q --q-bits 4
"""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from . import safetensors_io
from .nn.quantized import SUPPORTED_BITS, dequantize_arrays, quantize_arrays
from .utils import get_model_path, load_config, load_weight_files

MAX_FILE_SIZE_GB = 5

# Mixed-precision recipes: predicate(path) → bits override
QUANT_RECIPES = {
    "mixed_2_6": lambda p: 6 if ("lm_head" in p or "embed" in p) else 2,
    "mixed_3_4": lambda p: 4 if ("lm_head" in p or "embed" in p) else 3,
    "mixed_3_6": lambda p: 6 if ("lm_head" in p or "embed" in p) else 3,
    "mixed_4_6": lambda p: 6 if ("lm_head" in p or "embed" in p) else 4,
}

_TTS_TYPES = {
    "kokoro", "qwen3_tts", "sesame", "csm", "dia", "spark", "chatterbox",
    "chatterbox_turbo", "cosyvoice2", "cosyvoice3", "vibevoice", "outetts",
    "bark", "soprano", "indextts", "voxcpm", "pocket_tts", "echo_tts",
    "orpheus", "llama", "qwen3",
}
_STT_TYPES = {
    "whisper", "parakeet", "voxtral", "qwen3_asr", "funasr", "glmasr",
    "lasr", "wav2vec2",
}
_VAD_TYPES = {"sortformer", "smart_turn"}


def detect_model_domain(model_path: Path, config: dict) -> str:
    """tts / stt / vad / codec: the model_type, then the path, then the
    overlap of the config's keys with each domain's characteristic keys."""
    mt = (config.get("model_type") or "").lower().replace("-", "_")
    if mt in _TTS_TYPES:
        return "tts"
    if mt in _STT_TYPES:
        return "stt"
    if mt in _VAD_TYPES:
        return "vad"
    path_str = str(model_path).lower()
    for dom, keys in (
        ("tts", ("tts", "speech-synthesis", "kokoro", "voice")),
        ("stt", ("stt", "asr", "whisper", "transcri")),
        ("vad", ("vad", "diariz", "sortformer")),
        ("codec", ("codec", "snac", "encodec", "dac", "mimi", "vocos")),
    ):
        if any(k in path_str for k in keys):
            return dom
    # Jaccard overlap of the config's keys with each domain's
    keysets = {
        "stt": {"n_audio_ctx", "n_text_ctx", "encoder_layers", "decoder_layers"},
        "tts": {"istftnet", "vocab", "style_dim", "n_token", "audio_num_codebooks"},
        "codec": {"codebook_size", "upsampling_ratios", "encoder_rates"},
    }
    best, best_score = "tts", 0.0
    cfg_keys = set(config)
    for dom, ks in keysets.items():
        inter = len(cfg_keys & ks)
        union = len(cfg_keys | ks) or 1
        score = inter / union
        if inter and score > best_score:
            best, best_score = dom, score
    return best


def _tensor(w) -> torch.Tensor:
    """A weight (numpy array or torch tensor) as a CPU tensor."""
    if isinstance(w, torch.Tensor):
        return w.detach().cpu()
    w = np.asarray(w)
    return torch.from_numpy(w.copy() if not w.flags.writeable else w)


def _should_quantize(key: str, w, group_size: int) -> bool:
    if not key.endswith(".weight") or w.ndim != 2:
        return False
    if w.shape[-1] % group_size != 0:
        return False
    # skip tiny layers and norm-like params
    return w.shape[0] >= 8 and w.shape[1] >= group_size


def _packed(t: torch.Tensor) -> np.ndarray:
    """Packed words as the checkpoint holds them: uint32 (the port keeps
    the same bits as int32), or the 3/6-bit uint8 stream."""
    a = t.cpu().numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


def quantize_weights(weights: Dict[str, object], bits: int = 4, group_size: int = 64,
                     recipe: Optional[str] = None, predicate=None) -> Dict[str, object]:
    """Quantize every 2-D `.weight` that `_should_quantize` and `predicate(key,
    w)` admit: `key` becomes the packed words, with `.scales` and `.biases`
    (float32) beside it; everything else passes through."""
    out: Dict[str, object] = {}
    for k, w in weights.items():
        b = QUANT_RECIPES[recipe](k) if recipe else bits
        if b not in SUPPORTED_BITS:
            raise ValueError(f"unsupported bits={b} (supported: {SUPPORTED_BITS})")
        if (predicate is None or predicate(k, w)) and _should_quantize(k, w, group_size):
            base = k[: -len(".weight")]
            packed, scales, biases = quantize_arrays(_tensor(w).float(), group_size, b)
            out[k] = _packed(packed)
            out[base + ".scales"] = scales.numpy()
            out[base + ".biases"] = biases.numpy()
        else:
            out[k] = w
    return out


def dequantize_weights(weights: Dict[str, object], bits: int, group_size: int,
                       overrides: Optional[dict] = None) -> Dict[str, object]:
    """Every quantized layer back to a float32 `.weight`. `overrides` is the
    config's quantization block: per-path {"bits", "group_size"} take
    precedence over the defaults (mixed-recipe checkpoints)."""
    out = dict(weights)
    for k in [k for k in weights if k.endswith(".scales")]:
        base = k[: -len(".scales")]
        wkey = base + ".weight"
        if wkey not in weights:
            continue
        b, g = bits, group_size
        ov = (overrides or {}).get(base)
        if isinstance(ov, dict):
            b = ov.get("bits", b)
            g = ov.get("group_size", g)
        w = weights[wkey]
        if not isinstance(w, torch.Tensor) and np.asarray(w).dtype == np.uint32:
            w = np.asarray(w).view(np.int32)  # the port's words: the same bits
        packed = _tensor(w)
        deq = dequantize_arrays(packed, _tensor(weights[k]),
                                _tensor(weights[base + ".biases"]), g, b)
        out[wkey] = deq.numpy()
        out.pop(k)
        out.pop(base + ".biases", None)
    return out


def save_model(out_dir: Path, weights: Dict[str, object], config: dict):
    """Write safetensors shards of at most MAX_FILE_SIZE_GB, with
    `model.safetensors.index.json` where there is more than one, and
    config.json."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    max_bytes = MAX_FILE_SIZE_GB * 1024**3
    shards, cur, cur_size = [], {}, 0
    for k, w in weights.items():
        if not isinstance(w, torch.Tensor):
            w = np.asarray(w)
        nbytes = w.numel() * w.element_size() if isinstance(w, torch.Tensor) else w.nbytes
        if cur_size + nbytes > max_bytes and cur:
            shards.append(cur)
            cur, cur_size = {}, 0
        cur[k] = w
        cur_size += nbytes
    shards.append(cur)

    if len(shards) == 1:
        safetensors_io.save_file(shards[0], out_dir / "model.safetensors")
    else:
        index = {"weight_map": {}, "metadata": {"total_shards": len(shards)}}
        for i, shard in enumerate(shards, 1):
            name = f"model-{i:05d}-of-{len(shards):05d}.safetensors"
            safetensors_io.save_file(shard, out_dir / name)
            for k in shard:
                index["weight_map"][k] = name
        (out_dir / safetensors_io.INDEX_NAME).write_text(json.dumps(index))
    (out_dir / "config.json").write_text(json.dumps(config, indent=2))


def generate_readme(out_dir: Path, src: str, config: dict):
    mt = config.get("model_type", "audio")
    quant = config.get("quantization")
    body = (
        f"# {Path(src).name} (mlx_audio_tpu_torch)\n\n"
        f"Converted from `{src}` with `mlx_audio_tpu_torch.convert`.\n\n"
        f"- model_type: `{mt}`\n"
        + (f"- quantization: {quant['bits']}-bit, group size "
           f"{quant['group_size']}\n" if quant else "")
        + "\n```bash\npython -m mlx_audio_tpu_torch.tts.generate --model "
        f"{Path(out_dir).name} --text 'Hello.'\n```\n"
    )
    (Path(out_dir) / "README.md").write_text(body)


_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16, "float32": torch.float32}


def _cast(w, dtype: torch.dtype):
    """A float weight in `dtype`: numpy where numpy has the dtype, a torch
    tensor for bfloat16; other weights as they are."""
    t = _tensor(w)
    if not t.is_floating_point():
        return w
    t = t.to(dtype)
    return t if dtype == torch.bfloat16 else t.numpy()


def convert(model: str, output_path: Optional[str] = None, quantize: bool = False,
            q_bits: int = 4, q_group_size: int = 64, q_recipe=None, dequantize: bool = False,
            dtype: Optional[str] = None, upload_repo: Optional[str] = None,
            revision: Optional[str] = None, model_domain: Optional[str] = None) -> Path:
    """Convert the checkpoint directory `model` into `output_path`.
    `q_recipe` is a recipe name (QUANT_RECIPES) or a predicate(key, weight)
    choosing the layers to quantize."""
    if upload_repo:
        raise ValueError(f"upload_repo={upload_repo!r}: the PyTorch port does not upload "
                         "(it has no network access to a hub); upload the output directory "
                         "yourself")
    src_path = get_model_path(model, revision=revision)
    config = load_config(src_path)
    weights = load_weight_files(src_path)
    domain = model_domain or detect_model_domain(src_path, config)

    if dtype:
        weights = {k: _cast(w, _DTYPES[dtype]) for k, w in weights.items()}

    if dequantize and "quantization" in config:
        q = config.pop("quantization")
        weights = dequantize_weights(weights, q["bits"], q["group_size"], overrides=q)
    elif quantize:
        original_keys = set(weights)
        recipe = q_recipe if isinstance(q_recipe, str) else None
        predicate = q_recipe if callable(q_recipe) else None
        weights = quantize_weights(weights, q_bits, q_group_size, recipe, predicate=predicate)
        config["quantization"] = {"bits": q_bits, "group_size": q_group_size}
        if recipe:
            config["quantization"]["recipe"] = recipe
            # per-path overrides so the loader unpacks mixed bit-widths
            fn = QUANT_RECIPES[recipe]
            for k in original_keys:
                if k.endswith(".weight") and k[:-len(".weight")] + ".scales" in weights:
                    b = fn(k)
                    if b != q_bits:
                        config["quantization"][k[: -len(".weight")]] = {
                            "bits": b, "group_size": q_group_size,
                        }

    out = Path(
        output_path
        or f"{Path(model).name}-{'%d-bit' % q_bits if quantize else dtype or 'converted'}"
    )
    save_model(out, weights, config)
    generate_readme(out, model, config)
    # copy aux files (tokenizer, voices, Bark's EnCodec, Spark's BiCodec and
    # Wav2Vec2, the CosyVoice families' S3Tokenizer and tokenizer, …)
    for f in Path(src_path).iterdir():
        if f.suffix in (".json", ".txt", ".model", ".tiktoken") and f.name != "config.json" \
                and f.name != safetensors_io.INDEX_NAME:
            shutil.copy(f, out / f.name)
        if f.is_dir() and f.name in ("voices", "encodec", "BiCodec", "wav2vec2-large-xlsr-53",
                                     "s3tokenizer", "tokenizer"):
            shutil.copytree(f, out / f.name, dirs_exist_ok=True)
    print(f"✓ converted ({domain}) → {out}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Convert audio model checkpoints")
    p.add_argument("--model", "--hf-path", required=True)
    p.add_argument("--output-path", "--mlx-path", default=None)
    p.add_argument("-q", "--quantize", action="store_true")
    p.add_argument("--q-bits", type=int, default=4, choices=[2, 3, 4, 6, 8])
    p.add_argument("--q-group-size", type=int, default=64)
    p.add_argument("--q-recipe", "--quant-predicate", default=None,
                   choices=list(QUANT_RECIPES))
    p.add_argument("-d", "--dequantize", action="store_true")
    p.add_argument("--dtype", default=None,
                   choices=["float16", "bfloat16", "float32"])
    p.add_argument("--upload-repo", default=None,
                   help="not supported: the port does not upload")
    p.add_argument("--revision", default=None)
    p.add_argument("--model-domain", default=None,
                   choices=["tts", "stt", "sts", "vad", "codec"],
                   help="Override domain detection")
    args = p.parse_args(argv)
    convert(
        args.model, args.output_path, args.quantize, args.q_bits,
        args.q_group_size, args.q_recipe, args.dequantize, args.dtype,
        args.upload_repo, args.revision, args.model_domain,
    )


if __name__ == "__main__":
    main()
