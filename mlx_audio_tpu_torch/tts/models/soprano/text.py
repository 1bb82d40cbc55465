"""Soprano text cleaning (a copy of `mlx_audio_tpu/tts/models/soprano/text.py`,
whose package imports jax).

Behavioral spec: reference tts/models/soprano/text.py — the checkpoint is
trained on ASCII lowercase text with numbers, abbreviations, and symbols
spelled out, so `clean_text` must apply the same pipeline:
ascii-fold → numbers → abbreviations → special chars → lowercase →
strip-unknown → collapse whitespace → dedup punctuation. The
abbreviation/ordinal tables are fixed constants shared with the reference.
"""

from __future__ import annotations

import re
import unicodedata

_ONES = ["", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten", "eleven", "twelve", "thirteen",
         "fourteen", "fifteen", "sixteen", "seventeen", "eighteen",
         "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_ORDINALS = {
    1: "first", 2: "second", 3: "third", 4: "fourth", 5: "fifth",
    6: "sixth", 7: "seventh", 8: "eighth", 9: "ninth", 10: "tenth",
    11: "eleventh", 12: "twelfth", 13: "thirteenth", 14: "fourteenth",
    15: "fifteenth", 16: "sixteenth", 17: "seventeenth", 18: "eighteenth",
    19: "nineteenth", 20: "twentieth", 30: "thirtieth", 40: "fortieth",
    50: "fiftieth", 60: "sixtieth", 70: "seventieth", 80: "eightieth",
    90: "ninetieth",
}


def num_to_words(n: int) -> str:
    """Integer → English words (reference _num_to_words)."""
    if n < 0:
        return "minus " + num_to_words(-n)
    if n == 0:
        return "zero"
    if n < 20:
        return _ONES[n]
    if n < 100:
        return _TENS[n // 10] + ("" if n % 10 == 0 else " " + _ONES[n % 10])
    for base, name in ((100, "hundred"), (1000, "thousand"),
                       (10 ** 6, "million"), (10 ** 9, "billion")):
        if n < base * (1000 if base > 100 else 10):
            head, tail = divmod(n, base)
            out = num_to_words(head) + " " + name
            return out if tail == 0 else out + " " + num_to_words(tail)
    return num_to_words(n // 10 ** 9) + " billion" + (
        "" if n % 10 ** 9 == 0 else " " + num_to_words(n % 10 ** 9))


def ordinal_to_words(n: int) -> str:
    """Ordinal integer → English words (reference _ordinal_to_words)."""
    if n in _ORDINALS:
        return _ORDINALS[n]
    if n < 100:
        tens, ones = divmod(n, 10)
        if ones == 0:
            return _TENS[tens] + "th"
        return _TENS[tens] + " " + _ORDINALS.get(ones, _ONES[ones] + "th")
    base = num_to_words(n)
    return base[:-1] + "ieth" if base.endswith("y") else base + "th"


# dotted title abbreviations (case-insensitive, match "xx.")
_DOT_ABBREV = [
    ("mrs", "misuss"), ("ms", "miss"), ("mr", "mister"), ("dr", "doctor"),
    ("st", "saint"), ("co", "company"), ("jr", "junior"), ("maj", "major"),
    ("gen", "general"), ("drs", "doctors"), ("rev", "reverend"),
    ("lt", "lieutenant"), ("hon", "honorable"), ("sgt", "sergeant"),
    ("capt", "captain"), ("esq", "esquire"), ("ltd", "limited"),
    ("col", "colonel"), ("ft", "fort"),
]
# case-sensitive acronyms/units (match as whole words, no dot)
_CASED_ABBREV = [
    ("TTS", "text to speech"), ("Hz", "hertz"), ("kHz", "kilohertz"),
    ("KBs", "kilobytes"), ("KB", "kilobyte"), ("MBs", "megabytes"),
    ("MB", "megabyte"), ("GBs", "gigabytes"), ("GB", "gigabyte"),
    ("TBs", "terabytes"), ("TB", "terabyte"), ("APIs", "a p i's"),
    ("API", "a p i"), ("CLIs", "c l i's"), ("CLI", "c l i"),
    ("CPUs", "c p u's"), ("CPU", "c p u"), ("GPUs", "g p u's"),
    ("GPU", "g p u"), ("Ave", "avenue"), ("etc", "etcetera"),
]
_ABBREV_RES = (
    [(re.compile(rf"\b{a}\.", re.IGNORECASE), b) for a, b in _DOT_ABBREV]
    + [(re.compile(rf"\b{a}\b"), b) for a, b in _CASED_ABBREV]
)


def expand_abbreviations(text: str) -> str:
    for pat, rep in _ABBREV_RES:
        text = pat.sub(rep, text)
    return text


_SPECIALS = [(re.compile(p), r) for p, r in [
    ("@", " at "), ("&", " and "), ("%", " percent "), (":", "."),
    (";", ","), (r"\+", " plus "), (r"\\", " backslash "),
    ("~", " about "), ("<", " less than "), (">", " greater than "),
    ("=", " equals "), ("/", " slash "), ("_", " "),
]]


def expand_special_characters(text: str) -> str:
    for pat, rep in _SPECIALS:
        text = pat.sub(rep, text)
    return text


def _expand_dollars(m: re.Match) -> str:
    amount = m.group(1).replace(",", "")
    parts = amount.split(".")
    if len(parts) > 2:
        return amount + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    d_unit = "dollar" if dollars == 1 else "dollars"
    c_unit = "cent" if cents == 1 else "cents"
    if dollars and cents:
        return (f"{num_to_words(dollars)} {d_unit}, "
                f"{num_to_words(cents)} {c_unit}")
    if dollars:
        return f"{num_to_words(dollars)} {d_unit}"
    if cents:
        return f"{num_to_words(cents)} {c_unit}"
    return "zero dollars"


def _expand_plain(m: re.Match) -> str:
    n = int(m.group(0))
    # year-like pronunciation for 1001–2999 (reference _expand_number)
    if 1000 < n < 3000:
        if n == 2000:
            return "two thousand"
        if 2000 < n < 2010:
            return "two thousand " + num_to_words(n % 100)
        if n % 100 == 0:
            return num_to_words(n // 100) + " hundred"
        first, second = divmod(n, 100)
        if second < 10:
            return num_to_words(first) + " oh " + num_to_words(second)
        return num_to_words(first) + " " + num_to_words(second)
    return num_to_words(n)


_NUM_SUFFIXES = {"K": "thousand", "M": "million", "B": "billion",
                 "T": "trillion"}


def normalize_numbers(text: str) -> str:
    """Spell out #N, N{K,M,B,T}, $…, ordinals, and plain numbers
    (reference normalize_numbers)."""
    text = re.sub(r"#\d", lambda m: f"number {m.group(0)[1]}", text)
    text = re.sub(
        r"\d(K|M|B|T)",
        lambda m: f"{m.group(0)[0]} {_NUM_SUFFIXES[m.group(0)[1].upper()]}",
        text, flags=re.IGNORECASE)
    text = re.sub(r"(\d[\d,]+\d)",
                  lambda m: m.group(1).replace(",", ""), text)
    text = re.sub(r"\$([\d.,]*\d+)", _expand_dollars, text)
    text = re.sub(
        r"\d+(st|nd|rd|th)",
        lambda m: ordinal_to_words(
            int(re.sub(r"(st|nd|rd|th)$", "", m.group(0)))), text)
    text = re.sub(r"\d+", _expand_plain, text)
    return text


def convert_to_ascii(text: str) -> str:
    return unicodedata.normalize("NFKD", text).encode(
        "ascii", "ignore").decode("ascii")


def remove_unknown_characters(text: str) -> str:
    text = re.sub(r"[^A-Za-z !\$%&'\*\+,\-./0123456789<>\?_]", "", text)
    return re.sub(r"[<>/_+]", "", text)


def collapse_whitespace(text: str) -> str:
    text = re.sub(r"\s+", " ", text)
    return re.sub(r" ([.?!,])", r"\1", text).strip()


def dedup_punctuation(text: str) -> str:
    text = re.sub(r"\.\.\.+", "...", text)
    text = re.sub(r",+", ",", text)
    text = re.sub(r"[.,]*\.[.,]*", ".", text)
    text = re.sub(r"[.,!]*![.,!]*", "!", text)
    return re.sub(r"[.,!?]*\?[.,!?]*", "?", text)


def clean_text(text: str) -> str:
    """Full cleaning pipeline (reference clean_text, text.py:324-343)."""
    text = convert_to_ascii(text)
    text = normalize_numbers(text)
    text = expand_abbreviations(text)
    text = expand_special_characters(text)
    text = text.lower()
    text = remove_unknown_characters(text)
    text = collapse_whitespace(text)
    return dedup_punctuation(text)
