"""Model loading, registry and audio helpers (counterpart of
`mlx_audio_tpu/utils.py`).

The JAX package's contract: `load_config`, `load_weight_files`
(safetensors, npz, torch pickles → {key: array}), `apply_quantization`
(config-driven, per-layer predicates), `get_model_class`,
`base_load_model` and the domain-sniffing `load_model`; `load_audio` and
`resample_audio`. Where it differs:

- checkpoints are local directories or files: a hub id raises (the port
  does not download);
- safetensors files are read by the port's own reader (`safetensors_io`),
  so no `safetensors` package is needed;
- a model is built on an explicit device (`device=None` is the card) and
  in one float dtype (`dtype=None` takes the checkpoint's);
- only the families the port has resolve (`whisper`, `qwen3_tts`,
  `kokoro`, `llama` (Orpheus), `qwen3` (VyvoTTS), `sesame` (CSM, also
  as `csm`), `dia`, `outetts` (a `llama` config in a directory whose
  name carries `outetts`), `bark`, `spark`, `soprano`, `indextts`, `chatterbox` and
  `wav2vec` (also as `wav2vec2`)); any other raises the
  JAX package's "not supported" error;
- `resample_audio` is scipy's `resample_poly`, the JAX package's second
  route (its first is its native C resampler, not loaded here);
- tensor-parallel serving (`maybe_shard_for_serving`) is not ported.
"""

from __future__ import annotations

import dataclasses
import glob
import importlib
import json
import logging
from pathlib import Path
from typing import List, Optional, Tuple, Type, TypeVar, Union, get_origin, get_type_hints

import numpy as np
import torch

from . import safetensors_io
from .device import resolve_device
from .nn import quantized as nnq
from .nn import module as nn_module

T = TypeVar("T")

logger = logging.getLogger(__name__)

# the model families the port has, by category
PORTED = {"stt": ("whisper", "wav2vec", "wav2vec2"),
          "tts": ("qwen3_tts", "kokoro", "llama", "qwen3", "sesame", "dia", "outetts",
                  "bark", "spark", "soprano", "indextts", "chatterbox")}

NO_DOWNLOAD = ("the PyTorch port reads local checkpoint directories only and does not "
               "download: fetch {!r} first and pass its directory")


def from_dict(data_class: Type[T], data: dict) -> T:
    """Recursively build a dataclass from a dict, ignoring unknown keys."""
    if not dataclasses.is_dataclass(data_class):
        raise TypeError(f"{data_class} is not a dataclass")
    field_types = get_type_hints(data_class)
    kwargs = {}
    for field in dataclasses.fields(data_class):
        if field.name not in data:
            continue
        value = data[field.name]
        ftype = field_types[field.name]
        if get_origin(ftype) is Union:
            args = [a for a in ftype.__args__ if a is not type(None)]
            if args:
                ftype = args[0]
        if dataclasses.is_dataclass(ftype) and isinstance(value, dict):
            value = from_dict(ftype, value)
        kwargs[field.name] = value
    return data_class(**kwargs)


def _is_local_path(path: str) -> bool:
    return (
        path.startswith(".")
        or path.startswith("/")
        or path.startswith("~")
        or (len(path) > 1 and path[1] == ":")
    )


def get_model_path(path_or_hf_repo: Union[str, Path], revision: Optional[str] = None,
                   force_download: bool = False) -> Path:
    """A local directory or file. A missing local path raises
    FileNotFoundError, as in the JAX package; anything else would be a hub
    id, which raises ValueError (`revision` and `force_download`, the JAX
    package's download arguments, change nothing here)."""
    model_path = Path(path_or_hf_repo).expanduser()
    if model_path.exists():
        return model_path
    if _is_local_path(str(path_or_hf_repo)):
        raise FileNotFoundError(f"Local model path not found: {path_or_hf_repo}")
    raise ValueError(NO_DOWNLOAD.format(str(path_or_hf_repo)))


def load_config(model_path: Union[str, Path], **kwargs) -> dict:
    if isinstance(model_path, str):
        model_path = get_model_path(model_path, **kwargs)
    config_file = Path(model_path) / "config.json"
    if config_file.exists():
        with open(config_file, encoding="utf-8") as f:
            return json.load(f)
    raise FileNotFoundError(f"Config not found at {model_path}")


def load_weight_files(model_path: Union[str, Path]) -> dict:
    """All weights of a model directory → {key: array}: safetensors first
    (through the index of a sharded checkpoint where there is one), then
    npz, then torch pickles (.pt/.pth/.bin/.ckpt). A single weight file
    works too. Values are numpy arrays, or torch tensors where numpy has no
    dtype (bfloat16); safetensors values are views of a memory map."""
    model_path = Path(model_path)
    if model_path.is_file():
        return _load_one_weight_file(model_path)
    weights: dict = {}
    index = model_path / safetensors_io.INDEX_NAME
    weight_files = sorted(glob.glob(str(model_path / "*.safetensors")))
    if index.exists():
        weights.update(safetensors_io.load_sharded(index))
        indexed = set(json.loads(index.read_text(encoding="utf-8"))["weight_map"].values())
        weight_files = [f for f in weight_files if Path(f).name not in indexed]
    if weights or weight_files:
        for wf in weight_files:
            weights.update(safetensors_io.load_file(wf))
        return weights
    npz_files = sorted(glob.glob(str(model_path / "*.npz")))
    if npz_files:
        for wf in npz_files:
            with np.load(wf) as data:
                weights.update({k: data[k] for k in data.files})
        return weights
    torch_files = sorted(
        f for pat in ("*.pt", "*.pth", "*.bin", "*.ckpt")
        for f in glob.glob(str(model_path / pat))
        if not Path(f).name.startswith(("training_args", "optimizer",
                                        "scheduler", "rng_state"))
    )
    if not torch_files:
        raise FileNotFoundError(
            f"No weight files (safetensors/npz/pt) found in {model_path}"
        )
    loaded_any = False
    errors = []
    for wf in torch_files:
        try:
            weights.update(_load_one_weight_file(Path(wf)))
            loaded_any = True
        except Exception as e:  # non-weight pickle alongside the weights
            errors.append(f"{Path(wf).name}: {e}")
    if not loaded_any:
        raise ValueError(
            f"No torch file in {model_path} contained weights: {errors}")
    return weights


def _from_torch(t: torch.Tensor):
    t = t.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _load_one_weight_file(path: Path) -> dict:
    if path.suffix == ".safetensors":
        return safetensors_io.load_file(path)
    if path.suffix == ".npz":
        with np.load(path) as data:
            return {k: data[k] for k in data.files}
    if path.suffix in (".pt", ".pth", ".bin", ".ckpt"):
        state = torch.load(path, map_location="cpu", weights_only=True)
        for key in ("state_dict", "model_state_dict", "model"):
            if isinstance(state, dict) and key in state and isinstance(
                    state[key], dict):
                state = state[key]
                break
        return {k: _from_torch(v) for k, v in state.items() if hasattr(v, "detach")}
    raise ValueError(f"Unsupported weight file: {path}")


def apply_quantization(model: torch.nn.Module, config: dict, weights: dict,
                       model_quant_predicate=None) -> torch.nn.Module:
    """Swap Linear/Embedding → Quantized* per the config's `quantization`
    block, in place: the model's predicate may veto or override; then the
    block's per-path overrides; otherwise a layer is quantized iff
    `{path}.scales` is in the checkpoint."""
    quantization = config.get("quantization", None)
    if quantization is None:
        return model

    def predicate(path: str, module):
        if hasattr(module, "weight") and module.weight.numel() % 64 != 0:
            return False
        if model_quant_predicate is not None:
            r = model_quant_predicate(path, module)
            if isinstance(r, dict):
                return r
            if not r:
                return False
        if path in quantization:
            override = quantization[path]
            if isinstance(override, dict):
                return override
            if not override:
                return False
        return f"{path}.scales" in weights

    # the layout only: the checkpoint's words replace whatever is there
    return nnq.quantize_module(
        model,
        group_size=quantization.get("group_size", 64),
        bits=quantization.get("bits", 4),
        predicate=predicate,
        quantize=False,
    )


class UnsupportedModelError(ValueError):
    """A model type no ported family takes (the JAX package raises a plain
    ValueError with the same message)."""


def get_model_class(model_type: str, model_name: Optional[List[str]], category: str,
                    model_remapping: dict) -> Tuple:
    """The architecture module for a model type or name: the remapping dict
    first, then model-name parts against the families the port has."""
    model_type_mapped = model_remapping.get(model_type, None)
    available = list(PORTED.get(category, ()))

    if model_name is not None and model_type_mapped != model_type:
        for part in model_name:
            if part in available:
                model_type = part
            if part in model_remapping:
                model_type = model_remapping[part]
                break
        if model_type_mapped is not None and model_type not in available:
            model_type = model_type_mapped
    elif model_type_mapped is not None:
        model_type = model_type_mapped

    if model_type not in available:
        msg = f"Model type {model_type} not supported for {category}."
        logger.error(msg)
        raise UnsupportedModelError(msg)
    return importlib.import_module(f"{__package__}.{category}.models.{model_type}"), model_type


def _checkpoint_dtype(weights: dict) -> torch.dtype:
    """The one float dtype of a checkpoint's weights (quantization scales
    and biases aside): float16 or bfloat16 where they all are, else float32."""
    seen = set()
    for k, w in weights.items():
        if k.endswith((".scales", ".biases")):
            continue
        dt = w.dtype if isinstance(w, torch.Tensor) else np.asarray(w).dtype
        seen.add(str(dt).replace("torch.", ""))
    floats = seen & {"float16", "bfloat16", "float32", "float64"}
    if len(floats) == 1 and floats <= {"float16", "bfloat16"}:
        return getattr(torch, floats.pop())
    return torch.float32


def base_load_model(model_path: Union[str, Path], category: str, model_remapping: dict,
                    lazy: bool = False, strict: bool = False, device=None, dtype=None,
                    **kwargs):
    """Shared loader: resolve → config → class → build → sanitize →
    quantize → assign weights → post_load_hook → row-stack quantized
    siblings. The model is built on `device` (None: the card) in `dtype`
    (None: the checkpoint's float dtype); quantization scales stay float32.
    `lazy` is accepted for the JAX package's signature: weights are always
    read from a memory map and copied once, to the device."""
    model_name = None
    if isinstance(model_path, str):
        model_name = model_path.lower().split("/")[-1].split("-")
        model_path = get_model_path(model_path, revision=kwargs.get("revision", None),
                                    force_download=kwargs.get("force_download", False))
    elif isinstance(model_path, Path):
        try:
            index = model_path.parts.index("hub")
            model_name = model_path.parts[index + 1].lower().split("--")[-1].split("-")
        except ValueError:
            model_name = model_path.name.lower().split("-")
    else:
        raise ValueError(f"Invalid model path type: {type(model_path)}")
    device = resolve_device(device)

    config = load_config(model_path)
    config["model_path"] = str(model_path)

    model_type = config.get("model_type") or config.get("architecture")
    if model_type is None and model_name is not None:
        model_type = model_name[0].lower()

    model_class, model_type = get_model_class(model_type=model_type, model_name=model_name,
                                              category=category,
                                              model_remapping=model_remapping)
    model_config = (model_class.ModelConfig.from_dict(config)
                    if hasattr(model_class, "ModelConfig") else config)
    weights = load_weight_files(model_path)
    dtype = dtype or _checkpoint_dtype(weights)

    model = model_class.Model(model_config, device=device)
    if dtype != torch.float32:
        nn_module.cast_floats(model, dtype)
    if hasattr(model, "sanitize"):
        weights = model.sanitize(weights)
    apply_quantization(model, config, weights, getattr(model, "model_quant_predicate", None))
    nn_module.load_weights(model, weights, strict=strict,
                           not_built=getattr(model, "NOT_BUILT", ()))
    model = model.eval()

    # where the checkpoint lives, for pieces resolved from the same
    # directory (tokenizer files, voice packs)
    cfg = (getattr(model, "config", None) or getattr(model, "args", None)
           or getattr(model, "dims", None))
    if cfg is not None and not getattr(cfg, "model_path", None):
        cfg.model_path = str(model_path)

    if hasattr(type(model), "post_load_hook"):
        model = type(model).post_load_hook(model, model_path)
    # The JAX package shards the model for tensor-parallel serving here
    # (`maybe_shard_for_serving`); the port has no `parallel/` yet.
    # Row-stack quantized q/k/v and gate/up siblings: the checkpoint keeps
    # one module per projection, the fused layout is runtime-only.
    nnq.fuse_quantized_projections(model)
    return model


# -----------------------------------------------------------------------------
# Domain-agnostic load_model (sniffs tts/stt from the config or the name)
# -----------------------------------------------------------------------------

_STT_TYPES = {
    "whisper", "parakeet", "voxtral", "voxtral_realtime", "qwen3_asr",
    "vibevoice_asr", "funasr", "glmasr", "lasr", "lasr_ctc", "wav2vec",
    "wav2vec2",
}
_VAD_TYPES = {"sortformer", "smart_turn"}


def get_model_name_parts(model_path: Union[str, Path]) -> List[str]:
    """Lowercased dash-split tokens of the repo or directory name, the
    category hints where the config has no model_type."""
    name = str(model_path).rstrip("/").split("/")[-1]
    return name.lower().split("--")[-1].split("-")


def get_model_category(model_type: Optional[str],
                       name_parts: Optional[List[str]] = None) -> Optional[str]:
    """tts / stt from model_type or name hints: the registries' remapping
    keys first, then the families the port has."""
    from .stt.utils import MODEL_REMAPPING as stt_remap
    from .tts.utils import MODEL_REMAPPING as tts_remap

    candidates = [h for h in [model_type] + list(name_parts or []) if h]
    categories = [("tts", tts_remap), ("stt", stt_remap)]
    for category, remap in categories:
        for hint in candidates:
            if hint in remap:
                return category
    for category, _ in categories:
        for hint in candidates:
            if hint in PORTED[category]:
                return category
    return None


def load_model(model_path: Union[str, Path], **kwargs):
    """Load a model, sniffing its domain from the config's model_type, with
    the directory name's parts as hints where there is none."""
    path = get_model_path(model_path) if isinstance(model_path, str) else Path(model_path)
    try:
        config = load_config(path)
    except FileNotFoundError:
        config = {}
    model_type = (config.get("model_type") or "").lower().replace("-", "_")

    if not model_type:
        category = get_model_category(None, get_model_name_parts(model_path))
        if category == "stt":
            from .stt.utils import load_model as load_stt

            return load_stt(path, **kwargs)
        if category == "tts":
            from .tts.utils import load_model as load_tts

            return load_tts(path, **kwargs)

    if model_type in _STT_TYPES:
        from .stt.utils import load_model as load_stt

        return load_stt(path, **kwargs)
    if model_type in _VAD_TYPES:
        raise ValueError(f"Model type {model_type} not supported for vad.")
    from .tts.utils import load_model as load_tts

    try:
        return load_tts(path, **kwargs)
    except UnsupportedModelError:
        from .stt.utils import load_model as load_stt

        return load_stt(path, **kwargs)


# -----------------------------------------------------------------------------
# Audio loading
# -----------------------------------------------------------------------------


def load_audio(path: Union[str, Path], sample_rate: Optional[int] = None, dtype=np.float32,
               mono: bool = True, length: Optional[int] = None,
               volume_normalize: bool = False,
               segment_duration: Optional[float] = None) -> np.ndarray:
    """Read an audio file → float32 samples, the channels averaged when
    `mono`, resampled to `sample_rate` where it differs. `length` pads or
    cuts to an exact sample count, `volume_normalize` applies the
    percentile normalisation, and `segment_duration` picks a random clip of
    that many seconds."""
    from . import audio_io

    x, sr = audio_io.read(path)
    if mono and x.ndim == 2:
        x = x.mean(axis=1)
    if sample_rate is not None and sr != sample_rate:
        x = resample_audio(x, sr, sample_rate)
        sr = sample_rate
    x = x.astype(dtype)
    if segment_duration is not None:
        x = random_select_audio_segment(x, int(segment_duration * sr))
    if volume_normalize:
        x = audio_volume_normalize(x)
    if length is not None:
        if x.shape[0] < length:
            x = np.pad(x, (0, length - x.shape[0]))
        else:
            x = x[:length]
    return x


def audio_volume_normalize(audio: np.ndarray, coeff: float = 0.2) -> np.ndarray:
    """Scale so that the mean of the 90th-99th percentile |sample| values
    is `coeff`, clamped to 0.1×-10×, then |x| ≤ 1."""
    audio = np.asarray(audio)
    temp = np.sort(np.abs(audio))
    if temp.size == 0:
        return audio
    if temp[-1] < 0.1:
        audio = audio / max(float(temp[-1]), 1e-3) * 0.1
        temp = np.sort(np.abs(audio))
    temp = temp[temp > 0.01]
    if temp.shape[0] <= 10:
        return audio
    volume = float(np.mean(temp[int(0.9 * len(temp)): int(0.99 * len(temp))]))
    audio = audio * np.clip(coeff / volume, 0.1, 10)
    max_value = float(np.max(np.abs(audio)))
    if max_value > 1:
        audio = audio / max_value
    return audio


def random_select_audio_segment(audio: np.ndarray, length: int) -> np.ndarray:
    """A random clip of `length` samples, zero-padded if the audio is shorter."""
    import random

    audio = np.asarray(audio)
    if audio.shape[0] < length:
        audio = np.pad(audio, (0, int(length - audio.shape[0])))
    start = random.randint(0, audio.shape[0] - length)
    return audio[start: start + length]


def resample_audio(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling along axis 0 (scipy's `resample_poly`)."""
    if orig_sr == target_sr:
        return x
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_sr, target_sr)
    return resample_poly(x, target_sr // g, orig_sr // g, axis=0).astype(x.dtype)


def is_valid_module_name(name: str) -> bool:
    if not name or not isinstance(name, str):
        return False
    return name[0].isalpha() or name[0] == "_"
