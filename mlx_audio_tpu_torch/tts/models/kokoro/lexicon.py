"""CMUdict-scale pronunciation lexicon support for the Kokoro G2P fallback.

Host-only; a copy of `mlx_audio_tpu/tts/models/kokoro/lexicon.py`, kept
here so that the port imports nothing of the JAX package.

The reference hard-depends on misaki+espeak for G2P (reference
tts/models/kokoro/pipeline.py:96-131). This module lets the dependency-free
fallback reach dictionary quality whenever pronunciation data is present,
without any network access:

- `arpabet_to_misaki` converts CMU ARPAbet entries (the public-domain
  CMUdict format, ~134k words) to the misaki-style IPA the Kokoro vocab
  uses, including stress placement and intervocalic T-flapping.
- `load_cmudict` parses a cmudict-format file.
- `find_lexicon` looks for data in order: `MLX_AUDIO_TPU_LEXICON` (env,
  cmudict- or json-format path), a pre-built
  `data/lexicon_en.json(.gz)` next to this module (generate with
  `scripts/build_lexicon.py`), then nltk's cmudict corpus if downloaded.

`scripts/build_lexicon.py` converts a cmudict file into the compact json
form at build time so deployments ship a ~1.5 MB gzip instead of parsing
ARPAbet at import.
"""

from __future__ import annotations

import gzip
import json
import os
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["arpabet_to_misaki", "load_cmudict", "find_lexicon",
           "lexicon_from_cmudict"]

# CMU ARPAbet → misaki-style US IPA (the Kokoro vocab's conventions:
# A=eɪ, I=aɪ, O=oʊ, W=aʊ; ɔI for OY; ɾ for flapped T).
_VOWELS = {
    "AA": "ɑ", "AE": "æ", "AO": "ɔ", "AW": "W", "AY": "I",
    "EH": "ɛ", "EY": "A", "IH": "ɪ", "IY": "i", "OW": "O",
    "OY": "ɔI", "UH": "ʊ", "UW": "u",
}
_CONSONANTS = {
    "B": "b", "CH": "ʧ", "D": "d", "DH": "ð", "F": "f", "G": "ɡ",
    "HH": "h", "JH": "ʤ", "K": "k", "L": "l", "M": "m", "N": "n",
    "NG": "ŋ", "P": "p", "R": "ɹ", "S": "s", "SH": "ʃ", "T": "t",
    "TH": "θ", "V": "v", "W": "w", "Y": "j", "Z": "z", "ZH": "ʒ",
}


def arpabet_to_misaki(phones: List[str]) -> str:
    """['HH', 'AH0', 'L', 'OW1'] → 'həlˈO'.

    Stress digits place ˈ/ˌ immediately before the vowel symbol (misaki
    convention, e.g. 'sˈɛntəns'); AH0 reduces to schwa; ER fuses to
    ɜɹ/əɹ by stress; T between vowels with an unstressed right vowel
    flaps to ɾ ('lˈɪɾəl')."""
    out: List[str] = []
    syms: List[tuple] = []  # (symbol, is_vowel, stress)
    for p in phones:
        stress = ""
        base = p
        if base and base[-1] in "012":
            stress, base = base[-1], base[:-1]
        if base == "AH":
            sym = "ə" if stress == "0" else "ʌ"
            syms.append((sym, True, stress))
        elif base == "ER":
            syms.append(("ɜɹ" if stress in ("1", "2") else "əɹ", True,
                         stress))
        elif base in _VOWELS:
            syms.append((_VOWELS[base], True, stress))
        elif base in _CONSONANTS:
            syms.append((_CONSONANTS[base], False, ""))
        # unknown phones are dropped silently (robust to dict oddities)

    for i, (sym, is_vowel, stress) in enumerate(syms):
        if (sym == "t" and 0 < i < len(syms) - 1
                and syms[i - 1][1] and syms[i + 1][1]
                and syms[i + 1][2] not in ("1", "2")):
            out.append("ɾ")  # intervocalic flap
            continue
        if is_vowel and stress == "1":
            out.append("ˈ")
        elif is_vowel and stress == "2":
            out.append("ˌ")
        out.append(sym)
    return "".join(out)


def load_cmudict(path) -> Dict[str, List[str]]:
    """Parse a cmudict-format file: `WORD  P H O N E S`, `WORD(2) ...`
    variants ignored, `;;;` comments skipped. Keys lowercased."""
    lex: Dict[str, List[str]] = {}
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(";;;") or line.startswith("##"):
                continue
            parts = line.split()
            if len(parts) < 2:
                continue
            word = parts[0].lower()
            if word.endswith(")"):  # alternate pronunciation — keep first
                continue
            lex.setdefault(word, parts[1:])
    return lex


def lexicon_from_cmudict(path) -> Dict[str, str]:
    return {w: arpabet_to_misaki(p) for w, p in load_cmudict(path).items()}


def _load_json_lexicon(path) -> Dict[str, str]:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        return json.load(f)


def find_lexicon() -> Optional[Dict[str, str]]:
    """Best available big pronunciation lexicon, or None.

    Order: MLX_AUDIO_TPU_LEXICON env (json/json.gz prebuilt, else cmudict
    format) → bundled data/lexicon_en.json(.gz) → nltk cmudict corpus."""
    env = os.environ.get("MLX_AUDIO_TPU_LEXICON")
    if env and Path(env).exists():
        if env.endswith((".json", ".json.gz")):
            return _load_json_lexicon(env)
        return lexicon_from_cmudict(env)
    data_dir = Path(__file__).parent / "data"
    for name in ("lexicon_en.json.gz", "lexicon_en.json"):
        p = data_dir / name
        if p.exists():
            return _load_json_lexicon(p)
    try:  # nltk corpus, if its data was downloaded into the image
        from nltk.corpus import cmudict  # type: ignore

        return {w: arpabet_to_misaki(p[0]) for w, p in cmudict.dict().items()}
    except Exception:
        return None
