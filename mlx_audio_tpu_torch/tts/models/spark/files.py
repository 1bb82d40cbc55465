"""Spark dataset-metadata file helpers (a copy of
`mlx_audio_tpu/tts/models/spark/files.py`, whose package imports jax).

Behavioral spec: reference ``tts/models/spark/utils/file.py`` — JSONL /
pipe-delimited-metadata / CSV round-trips and YAML config loading with
``base_config`` deep-merge, used by the Spark data-prep tooling. Kept
dependency-light: ``yaml`` is imported lazily (only ``load_config`` needs
it).
"""

from __future__ import annotations

import csv
import json
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "resolve_symbolic_link", "write_jsonl", "read_jsonl",
    "read_json_as_jsonl", "decode_unicode_strings", "load_config",
    "jsonl_to_csv", "save_metadata", "read_metadata",
]


def resolve_symbolic_link(symbolic_link_path) -> str:
    """Absolute target of a symlink, resolved relative to its directory."""
    link_dir = os.path.dirname(symbolic_link_path)
    return os.path.join(link_dir, os.readlink(symbolic_link_path))


def write_jsonl(metadata: List[dict], file_path) -> None:
    with open(file_path, "w", encoding="utf-8") as f:
        f.writelines(json.dumps(m, ensure_ascii=False) + "\n"
                     for m in metadata)


def read_jsonl(file_path) -> List[dict]:
    with open(file_path, "r", encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def read_json_as_jsonl(file_path) -> List[dict]:
    """Flatten a {key: record} JSON object into a key-sorted record list,
    each record gaining an ``index`` field holding its key."""
    with open(file_path, "r", encoding="utf-8") as f:
        data = json.load(f)
    return [{"index": k, **data[k]} for k in sorted(data)]


def decode_unicode_strings(meta: Dict[str, Any]) -> Dict[str, Any]:
    return {k: (v.encode("utf-8").decode("unicode_escape")
                if isinstance(v, str) else v)
            for k, v in meta.items()}


def _deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    merged = dict(base)
    for key, value in override.items():
        if isinstance(merged.get(key), dict) and isinstance(value, dict):
            merged[key] = _deep_merge(merged[key], value)
        else:
            merged[key] = value
    return merged


def load_config(config_path) -> Dict[str, Any]:
    """YAML config; if it names a ``base_config``, deep-merge on top of it."""
    import yaml

    with open(config_path, "r") as f:
        config = yaml.safe_load(f)
    base_path = config.get("base_config")
    if base_path is not None:
        with open(base_path, "r") as f:
            config = _deep_merge(yaml.safe_load(f), config)
    return config


def jsonl_to_csv(jsonl_file_path, csv_file_path) -> None:
    """CSV with the union of keys across all records as sorted columns."""
    rows = read_jsonl(jsonl_file_path)
    columns = sorted({k for row in rows for k in row})
    with open(csv_file_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=columns)
        writer.writeheader()
        writer.writerows(rows)


def save_metadata(data: List[dict], filename,
                  headers: Optional[List[str]] = None) -> None:
    """Pipe-delimited metadata table; '|' inside values becomes a space."""
    headers = headers or list(data[0].keys())
    with open(filename, "w", encoding="utf-8") as f:
        f.write("|".join(headers) + "\n")
        for entry in data:
            f.write("|".join(str(entry.get(k, "")).replace("|", " ")
                             for k in headers) + "\n")


def read_metadata(filename, headers: Optional[List[str]] = None
                  ) -> Tuple[List[dict], List[str]]:
    with open(filename, "r", encoding="utf-8") as f:
        lines = [ln.strip() for ln in f]
    if headers is None:
        headers, lines = lines[0].split("|"), lines[1:]
    return ([dict(zip(headers, ln.split("|"))) for ln in lines if ln],
            headers)
