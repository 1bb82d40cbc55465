"""Convert Chatterbox's release files (ve.safetensors, t3_cfg.safetensors,
s3gen.safetensors, tokenizer.json) into one checkpoint directory with
component prefixes (ve., t3., s3gen.) (counterpart of
`mlx_audio_tpu/tts/models/chatterbox/convert.py`).

The S3Tokenizer's own `tokenizer.*` keys in s3gen.safetensors are dropped,
as there; a source's `s3tokenizer/` directory (the S3TokenizerV2 weights
the port reads, since it downloads nothing) is copied into the output,
as are `tokenizer.json` and `conds.pt`. `--quantize` quantizes T3's Llama
layers (`t3.tfmr.`) only.

    python -m mlx_audio_tpu_torch.tts.models.chatterbox.convert \\
        --source <dir> --output-dir <dir> [--quantize --q-bits 4 --q-group-size 64]
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path
from typing import Optional

COMPONENT_FILES = (("ve", "ve.safetensors"), ("t3", "t3_cfg.safetensors"),
                   ("s3gen", "s3gen.safetensors"))


def convert(source: str, output_dir: str, quantize: bool = False, bits: int = 4,
            group_size: int = 64, upload_repo: Optional[str] = None,
            model_config: Optional[dict] = None) -> Path:
    from ....convert import quantize_weights, save_model
    from ....utils import get_model_path, load_weight_files
    from .chatterbox import S3TOKENIZER_DIR, sanitize_weights

    if upload_repo:
        raise ValueError("the PyTorch port does not upload checkpoints")
    src = get_model_path(source)
    weights = {}
    for prefix, fname in COMPONENT_FILES:
        f = Path(src) / fname
        if not f.exists():
            raise FileNotFoundError(f"{source}: missing {fname}")
        w = load_weight_files(f)
        if prefix == "s3gen":  # the S3Tokenizer ships apart
            w = {k: v for k, v in w.items() if not k.startswith("tokenizer.")}
        weights.update({f"{prefix}.{k}": v for k, v in w.items()})
    weights = sanitize_weights(weights)

    config = {"model_type": "chatterbox", "version": "1.0"}
    if model_config:  # the tensors' shapes follow it: load_model rebuilds from it
        config.update(model_config)
    if quantize:
        # T3's Llama layers carry most of the parameters; the conditioning
        # and the vocoder stay float
        weights = quantize_weights(weights, bits, group_size,
                                   predicate=lambda k, w: k.startswith("t3.tfmr."))
        config["quantization"] = {"bits": bits, "group_size": group_size,
                                  "quantized_components": ["t3.tfmr"]}

    out = Path(output_dir)
    save_model(out, weights, config)
    for name in ("tokenizer.json", "conds.pt"):
        if (Path(src) / name).exists():
            shutil.copy(Path(src) / name, out / name)
    if (Path(src) / S3TOKENIZER_DIR).is_dir():
        shutil.copytree(Path(src) / S3TOKENIZER_DIR, out / S3TOKENIZER_DIR, dirs_exist_ok=True)
    print(f"converted {source} -> {out} ({len(weights)} tensors)")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Convert Chatterbox's release files into a "
                                            "checkpoint directory")
    p.add_argument("--source", required=True,
                   help="a local directory with the ve/t3_cfg/s3gen safetensors")
    p.add_argument("--output-dir", required=True)
    p.add_argument("-q", "--quantize", action="store_true")
    p.add_argument("--q-bits", type=int, default=4, choices=[2, 3, 4, 6, 8])
    p.add_argument("--q-group-size", type=int, default=64)
    args = p.parse_args(argv)
    convert(args.source, args.output_dir, args.quantize, args.q_bits, args.q_group_size)


if __name__ == "__main__":
    main()
