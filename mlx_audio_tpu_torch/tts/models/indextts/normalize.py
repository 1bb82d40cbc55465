"""IndexTTS text normalization (a copy of
`mlx_audio_tpu/tts/models/indextts/normalize.py`, whose package imports
jax).

Behavioral spec: reference tts/models/indextts/normalize.py — route text to
a Chinese or English normalizer (`use_chinese` heuristic), spell out
numbers/currency in English, protect pinyin + CJK proper names through
placeholder substitution in Chinese, map full-width punctuation to the
tokenizer's alphabet, and space-tokenize CJK characters
(`tokenize_by_CJK_char`). The punctuation tables and pinyin regex are fixed
constants shared with the reference.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

# punctuation / quote folding table (fixed constant)
_CHAR_MAP = {
    "：": ",", "；": ",", ";": ",", "，": ",", "。": ".", "！": "!",
    "？": "?", "\n": " ", "·": "-", "、": ",", "...": "…", ",,,": "…",
    "，，，": "…", "……": "…", "“": "'", "”": "'", '"': "'", "'": "'",
    "（": "'", "）": "'", "(": "'", ")": "'", "《": "'", "》": "'",
    "【": "'", "】": "'", "[": "'", "]": "'", "—": "-", "～": "-",
    "~": "-", "「": "'", "」": "'", ":": ",",
}
_ZH_CHAR_MAP = {"$": ".", **_CHAR_MAP}

PINYIN_PATTERN = (
    r"(?<![a-z])((?:[bpmfdtnlgkhjqxzcsryw]|[zcs]h)?"
    r"(?:[aeiouüv]|[ae]i|u[aio]|ao|ou|i[aue]|[uüv]e|[uvü]ang?|uai|"
    r"[aeiuv]n|[aeio]ng|ia[no]|i[ao]ng)|ng|er)([1-5])"
)
NAME_PATTERN = "[一-鿿]+(?:[-·—][一-鿿]+){1,2}"
_CONTRACTIONS = r"(what|where|who|which|how|t?here|it|s?he|that|this)'s"
_EMAIL = r"^[a-zA-Z0-9]+@[a-zA-Z0-9]+\.[a-zA-Z]+$"


def is_email(text: str) -> bool:
    return bool(re.match(_EMAIL, text))


def has_chinese(text: str) -> bool:
    return bool(re.search("[一-鿿]", text))


def has_alpha(text: str) -> bool:
    return bool(re.search(r"[a-zA-Z]", text))


def has_pinyin(text: str) -> bool:
    return bool(re.search(PINYIN_PATTERN, text, re.IGNORECASE))


def use_chinese(text: str) -> bool:
    """Route to the Chinese normalizer for CJK text, non-alphabetic text,
    e-mail-shaped tokens, and tone-marked pinyin."""
    return (has_chinese(text) or not has_alpha(text) or is_email(text)
            or has_pinyin(text))


def _fold_chars(text: str, table: Dict[str, str]) -> str:
    pat = re.compile("|".join(re.escape(k) for k in table))
    return pat.sub(lambda m: table[m.group()], text)


def _expand_contractions(text: str) -> str:
    return re.sub(_CONTRACTIONS, r"\1 is", text, flags=re.IGNORECASE)


def correct_pinyin(pinyin: str) -> str:
    """j/q/x + u → v respelling, uppercased (reference correct_pinyin)."""
    if pinyin[0] not in "jqxJQX":
        return pinyin
    return re.sub(r"([jqx])[uü](n|e|an)*(\d)", r"\g<1>v\g<2>\g<3>",
                  pinyin, flags=re.IGNORECASE).upper()


# ---------------------------------------------------------------------------
# placeholder protection for spans the normalizer must not touch
# ---------------------------------------------------------------------------

def _protect(text: str, pattern: str,
             prefix: str) -> Tuple[str, Dict[str, str]]:
    found = re.findall(re.compile(pattern, re.IGNORECASE), text)
    spans = sorted({("".join(m) if isinstance(m, tuple) else m)
                    for m in found})
    table = {s: f"<{prefix}_{chr(ord('a') + i)}>"
             for i, s in enumerate(spans)}
    for s, ph in table.items():
        text = text.replace(s, ph)
    return text, table


def _restore(text: str, table: Dict[str, str], transform=None) -> str:
    for s, ph in table.items():
        text = text.replace(ph, transform(s) if transform else s)
    return text


# ---------------------------------------------------------------------------
# English number spelling
# ---------------------------------------------------------------------------

_ONES = ["", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine"]
_TEENS = ["ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
          "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_GROUPS = ["", "thousand", "million", "billion", "trillion"]


def _under_1000(n: int) -> str:
    if n == 0:
        return ""
    if n < 10:
        return _ONES[n]
    if n < 20:
        return _TEENS[n - 10]
    if n < 100:
        return _TENS[n // 10] + (" " + _ONES[n % 10] if n % 10 else "")
    return (_ONES[n // 100] + " hundred"
            + (" " + _under_1000(n % 100) if n % 100 else ""))


def number_to_words(n: int) -> str:
    """Integer → English words (reference number_to_words)."""
    if n == 0:
        return "zero"
    words: List[str] = []
    gi = 0
    while n > 0:
        g = n % 1000
        if g:
            part = _under_1000(g)
            if _GROUPS[gi]:
                part += " " + _GROUPS[gi]
            words.append(part)
        n //= 1000
        gi += 1
    return " ".join(reversed(words))


def _digits_of(text: str) -> str:
    return "".join(ch for ch in text if ch.isdigit())


def normalize_english(text: str) -> str:
    text = _expand_contractions(text)
    try:
        def currency(m: re.Match) -> str:
            digits = _digits_of(m.group(0))
            if not digits:
                return m.group(0)
            n = int(digits)
            return f"{number_to_words(n)} dollar{'s' if n != 1 else ''} "

        text = re.sub(r"\$\s*[0-9,.\s]+", currency, text).rstrip()

        def spaced_digits(m: re.Match) -> str:
            parts = m.group(0).split()
            if all(len(p) == 1 and p.isdigit() for p in parts):
                return " ".join(number_to_words(int(p)) for p in parts)
            return number_to_words(int(_digits_of(m.group(0))))

        text = re.sub(r"\b\d(\s+\d)+\b", spaced_digits, text)

        def plain_number(m: re.Match) -> str:
            digits = _digits_of(m.group(0))
            return number_to_words(int(digits)) if digits else m.group(0)

        text = re.sub(r"\b\d+(?:,\d+)*\b", plain_number, text)
        text = re.sub(r"\s+", " ", text).strip()
    except Exception:
        pass
    return _fold_chars(text, _CHAR_MAP)


def normalize_chinese(text: str) -> str:
    text = _expand_contractions(text.rstrip())
    text, pinyin_map = _protect(text, PINYIN_PATTERN, "pinyin")
    text, name_map = _protect(text, NAME_PATTERN, "n")
    text = _restore(text, name_map)
    text = _restore(text, pinyin_map, correct_pinyin)
    return _fold_chars(text, _ZH_CHAR_MAP)


def normalize(text: str) -> str:
    """Route text to the Chinese or English normalizer."""
    return (normalize_chinese if use_chinese(text)
            else normalize_english)(text)


_CJK_RANGE = (r"([ᄀ-ᇿ⺀-꓏ꡀ-힯豈-﫿"
              r"︰-﹏･-ￜ\U00020000-\U0002FFFF])")


def tokenize_by_CJK_char(line: str, do_upper_case: bool = True) -> str:
    """Space-separate every CJK character; uppercase the rest
    (reference tokenize_by_CJK_char)."""
    parts = re.split(_CJK_RANGE, line.strip())
    return " ".join(p.strip().upper() if do_upper_case else p.strip()
                    for p in parts if p.strip())
