"""Convert an original OpenAI Whisper checkpoint (.pt with {dims,
model_state_dict}) to a checkpoint directory (config.json + safetensors):
the port's counterpart of `mlx_audio_tpu/stt/models/whisper/convert.py`,
writing the same files byte for byte.

HF-layout checkpoints need no conversion (`Model.sanitize` maps them at
load); this covers the openai release format, whose dims live inside the
pickle. The official names and URLs stay here as data: the port downloads
nothing, so a name instead of a file raises with the URL to fetch.

    python -m mlx_audio_tpu_torch.stt.models.whisper.convert \
        --torch-ckpt large-v3-turbo.pt --output-dir ./whisper-large-v3-turbo
"""

from __future__ import annotations

import argparse
import base64
import gzip
from pathlib import Path
from typing import List, Optional

import numpy as np

# Official OpenAI release URLs (the sha256 is the parent path segment) and
# the base85-gzipped word-timing alignment-head masks that ship with them:
# fixed public constants (reference scripts/convert.py:31-66).
_BASE = "https://openaipublic.azureedge.net/main/whisper/models"
_MODELS = {
    "tiny.en": f"{_BASE}/d3dd57d32accea0b295c96e26691aa14d8822fac7d9d27d5dc00b4ca2826dd03/tiny.en.pt",
    "tiny": f"{_BASE}/65147644a518d12f04e32d6f3b26facc3f8dd46e5390956a9424a650c0ce22b9/tiny.pt",
    "base.en": f"{_BASE}/25a8566e1d0c1e2231d1c762132cd20e0f96a85d16145c3a00adf5d1ac670ead/base.en.pt",
    "base": f"{_BASE}/ed3a0b6b1c0edf879ad9b11b1af5a0e6ab5db9205f891f668f8b0e6c6326e34e/base.pt",
    "small.en": f"{_BASE}/f953ad0fd29cacd07d5a9eda5624af0f6bcf2258be67c92b79389873d91e0872/small.en.pt",
    "small": f"{_BASE}/9ecf779972d90ba49c06d968637d720dd632c55bbf19d441fb42bf17a411e794/small.pt",
    "medium.en": f"{_BASE}/d7440d1dc186f76616474e0ff0b3b6b879abc9d1a4926b7adfa41db2d497ab4f/medium.en.pt",
    "medium": f"{_BASE}/345ae4da62f9b3d59415adc60127b97c714f32e89e936602e85993674d08dcb1/medium.pt",
    "large-v1": f"{_BASE}/e4b87e7e0bf463eb8e6956e646f1e277e901512310def2c24bf0e11bd3c28e9a/large-v1.pt",
    "large-v2": f"{_BASE}/81f7c96c852ee8fc832187b0132e569d6c3065a3252ed18e56effd0b6a73e524/large-v2.pt",
    "large-v3": f"{_BASE}/e5b1a55b89c1367dacf97e3e19bfd829a01529dbfdeefa8caeb59b3f1b81dadb/large-v3.pt",
    "large": f"{_BASE}/e5b1a55b89c1367dacf97e3e19bfd829a01529dbfdeefa8caeb59b3f1b81dadb/large-v3.pt",
    "large-v3-turbo": f"{_BASE}/aff26ae408abcba5fbf8813c21e62b0941638c5f6eebfb145be0c9839262a19a/large-v3-turbo.pt",
    "turbo": f"{_BASE}/aff26ae408abcba5fbf8813c21e62b0941638c5f6eebfb145be0c9839262a19a/large-v3-turbo.pt",
}
_ALIGNMENT_HEADS = {
    "tiny.en": b"ABzY8J1N>@0{>%R00Bk>$p{7v037`oCl~+#00",
    "tiny": b"ABzY8bu8Lr0{>%RKn9Fp%m@SkK7Kt=7ytkO",
    "base.en": b"ABzY8;40c<0{>%RzzG;p*o+Vo09|#PsxSZm00",
    "base": b"ABzY8KQ!870{>%RzyTQH3`Q^yNP!>##QT-<FaQ7m",
    "small.en": b"ABzY8>?_)10{>%RpeA61k&I|OI3I$65C{;;pbCHh0B{qLQ;+}v00",
    "small": b"ABzY8DmU6=0{>%Rpa?J`kvJ6qF(V^F86#Xh7JUGMK}P<N0000",
    "medium.en": b"ABzY8usPae0{>%R7<zz_OvQ{)4kMa0BMw6u5rT}kRKX;$NfYBv00*Hl@qhsU00",
    "medium": b"ABzY8B0Jh+0{>%R7}kK1fFL7w6%<-Pf*t^=N)Qr&0RR9",
    "large-v1": b"ABzY8r9j$a0{>%R7#4sLmoOs{s)o3~84-RPdcFk!JR<kSfC2yj",
    "large-v2": b"ABzY8zd+h!0{>%R7=D0pU<_bnWW*tkYAhobTNnu$jnkEkXqp)j;w1Tzk)UH3X%SZd&fFZ2fC2yj",
    "large-v3": b"ABzY8gWO1E0{>%R7(9S+Kn!D~%ngiGaR?*L!iJG9p-nab0JQ=-{D1-g00",
    "large": b"ABzY8gWO1E0{>%R7(9S+Kn!D~%ngiGaR?*L!iJG9p-nab0JQ=-{D1-g00",
    "large-v3-turbo": b"ABzY8j^C+e0{>%RARaKHP%t(lGR*)0g!tONPyhe`",
    "turbo": b"ABzY8j^C+e0{>%RARaKHP%t(lGR*)0g!tONPyhe`",
}


def available_models() -> List[str]:
    """Official OpenAI model names (reference scripts/convert.py:126-128)."""
    return list(_MODELS.keys())


def decode_alignment_heads(dump: bytes, n_text_layer: int,
                           n_text_head: int) -> List[List[int]]:
    """base85+gzip boolean (layer, head) mask → list of [layer, head]
    pairs (reference whisper.py:518-526 set_alignment_heads)."""
    array = np.frombuffer(gzip.decompress(base64.b85decode(dump)), dtype=bool).copy()
    mask = array.reshape(n_text_layer, n_text_head)
    return [[int(l), int(h)] for l, h in zip(*mask.nonzero())]


def _variant_from_name(name_or_path: str) -> Optional[str]:
    """Model variant for the alignment-heads lookup (reference :68-78)."""
    if name_or_path in _ALIGNMENT_HEADS:
        return name_or_path
    name = Path(str(name_or_path)).name
    if name.endswith(".pt"):
        name = name[:-3]
    if name.startswith("whisper-"):
        name = name[8:]
    return name if name in _ALIGNMENT_HEADS else None


def convert(torch_ckpt: str, output_dir: str, dtype: str = "float32") -> Path:
    import torch

    from ....convert import save_model

    if torch_ckpt in _MODELS and not Path(torch_ckpt).is_file():
        raise ValueError(f"{torch_ckpt!r} names an official checkpoint; the port downloads "
                         f"nothing: fetch {_MODELS[torch_ckpt]} and pass the file")
    state = torch.load(torch_ckpt, map_location="cpu", weights_only=True)
    if not isinstance(state, dict) or "dims" not in state:
        raise ValueError(f"{torch_ckpt}: not an OpenAI whisper checkpoint "
                         "(expected {'dims', 'model_state_dict'})")
    dims = dict(state["dims"])
    dims["model_type"] = "whisper"
    variant = _variant_from_name(torch_ckpt)
    if variant is not None:
        try:
            dims["alignment_heads"] = decode_alignment_heads(
                _ALIGNMENT_HEADS[variant], dims["n_text_layer"], dims["n_text_head"])
        except ValueError:
            # a file named after an official variant whose decoder shape is
            # not that variant's (a custom model named tiny.pt): no heads
            # rather than wrong ones
            pass
    cast = {"float16": torch.float16, "bfloat16": torch.bfloat16,
            "float32": torch.float32}[dtype]
    weights = {}
    for k, v in state["model_state_dict"].items():
        v = v.detach().cpu()
        if v.is_floating_point():
            v = v.to(cast)
        # numpy where it can hold the dtype; bfloat16 stays a torch tensor
        weights[k] = v if v.dtype == torch.bfloat16 else v.contiguous().numpy()
    out = Path(output_dir)
    save_model(out, weights, dims)
    print(f"✓ converted {torch_ckpt} → {out} ({len(weights)} tensors)")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Convert OpenAI whisper .pt → checkpoint dir")
    p.add_argument("--torch-ckpt", required=True,
                   help="the .pt file (an official name raises: nothing is downloaded)")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--dtype", default="float32", choices=["float16", "bfloat16", "float32"])
    args = p.parse_args(argv)
    convert(args.torch_ckpt, args.output_dir, args.dtype)


if __name__ == "__main__":
    main()
