"""Grapheme→phoneme providers for Kokoro.

Host-only; a copy of `mlx_audio_tpu/tts/models/kokoro/g2p.py`, kept
here so that the port imports nothing of the JAX package.

The reference depends on `misaki` (+espeak-ng) for G2P (pipeline.py:96-131).
Those are host-side CPU dependencies; this module auto-detects them and
falls back to a built-in lexicon/rule English G2P so the pipeline runs
end-to-end in dependency-free environments (quality-limited fallback — the
phoneme *pipeline contract* is identical: tokens with `.phonemes` and
`.whitespace`, misaki-style IPA symbols from the Kokoro vocab).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

__all__ = ["PhonemeToken", "get_g2p", "BasicEnglishG2P"]


@dataclass
class PhonemeToken:
    text: str
    phonemes: Optional[str] = None
    whitespace: str = " "
    start_ts: Optional[float] = None
    end_ts: Optional[float] = None


# ~130 most common English words, hand-mapped to misaki-style US IPA.
_LEXICON = {
    "the": "ðə", "a": "ə", "an": "ən", "and": "ænd", "of": "əv", "to": "tˈu",
    "in": "ˈɪn", "is": "ˈɪz", "it": "ˈɪt", "you": "jˈu", "that": "ðˈæt",
    "he": "hˈi", "she": "ʃˈi", "was": "wˈʌz", "for": "fɔɹ", "on": "ˈɑn",
    "are": "ˈɑɹ", "as": "ˈæz", "with": "wˈɪð", "his": "hˈɪz", "her": "hɜɹ",
    "they": "ðˈA", "i": "ˈI", "at": "ˈæt", "be": "bˈi", "this": "ðˈɪs",
    "have": "hˈæv", "from": "fɹˈʌm", "or": "ɔɹ", "one": "wˈʌn", "had": "hˈæd",
    "by": "bˈI", "word": "wˈɜɹd", "but": "bˈʌt", "not": "nˈɑt",
    "what": "wˈʌt", "all": "ˈɔl", "were": "wɜɹ", "we": "wˈi", "when": "wˈɛn",
    "your": "jʊɹ", "can": "kˈæn", "said": "sˈɛd", "there": "ðˈɛɹ",
    "each": "ˈiʧ", "which": "wˈɪʧ", "do": "dˈu", "how": "hˈW", "their": "ðˈɛɹ",
    "if": "ˈɪf", "will": "wˈɪl", "up": "ˈʌp", "other": "ˈʌðəɹ",
    "about": "əbˈWt", "out": "ˈWt", "many": "mˈɛni", "then": "ðˈɛn",
    "them": "ðˈɛm", "these": "ðˈiz", "so": "sˈO", "some": "sˈʌm",
    "would": "wˈʊd", "make": "mˈAk", "like": "lˈIk", "him": "hˈɪm",
    "into": "ˈɪntu", "time": "tˈIm", "has": "hˈæz", "look": "lˈʊk",
    "two": "tˈu", "more": "mˈɔɹ", "write": "ɹˈIt", "go": "ɡˈO",
    "see": "sˈi", "number": "nˈʌmbəɹ", "no": "nˈO", "way": "wˈA",
    "could": "kˈʊd", "people": "pˈipəl", "my": "mˈI", "than": "ðˈæn",
    "first": "fˈɜɹst", "water": "wˈɔtəɹ", "been": "bˈɪn", "call": "kˈɔl",
    "who": "hˈu", "its": "ˈɪts", "now": "nˈW", "find": "fˈInd",
    "long": "lˈɔŋ", "down": "dˈWn", "day": "dˈA", "did": "dˈɪd",
    "get": "ɡˈɛt", "come": "kˈʌm", "made": "mˈAd", "may": "mˈA",
    "part": "pˈɑɹt", "over": "ˈOvəɹ", "new": "nˈu", "sound": "sˈWnd",
    "take": "tˈAk", "only": "ˈOnli", "little": "lˈɪɾəl", "work": "wˈɜɹk",
    "know": "nˈO", "place": "plˈAs", "year": "jˈɪɹ", "live": "lˈɪv",
    "me": "mˈi", "back": "bˈæk", "give": "ɡˈɪv", "most": "mˈOst",
    "very": "vˈɛɹi", "after": "ˈæftəɹ", "thing": "θˈɪŋ", "our": "ˈWɹ",
    "just": "ʤˈʌst", "name": "nˈAm", "good": "ɡˈʊd", "sentence": "sˈɛntəns",
    "man": "mˈæn", "think": "θˈɪŋk", "say": "sˈA", "great": "ɡɹˈAt",
    "where": "wˈɛɹ", "help": "hˈɛlp", "through": "θɹˈu", "much": "mˈʌʧ",
    "before": "bɪfˈɔɹ", "line": "lˈIn", "right": "ɹˈIt", "too": "tˈu",
    "means": "mˈinz", "old": "ˈOld", "any": "ˈɛni", "same": "sˈAm",
    "tell": "tˈɛl", "boy": "bˈɔI", "follow": "fˈɑlO", "came": "kˈAm",
    "want": "wˈɑnt", "show": "ʃˈO", "also": "ˈɔlsO", "around": "əɹˈWnd",
    "form": "fˈɔɹm", "three": "θɹˈi", "small": "smˈɔl", "set": "sˈɛt",
    "put": "pˈʊt", "end": "ˈɛnd", "does": "dˈʌz", "another": "ənˈʌðəɹ",
    "well": "wˈɛl", "large": "lˈɑɹʤ", "must": "mˈʌst", "big": "bˈɪɡ",
    "even": "ˈivən", "such": "sˈʌʧ", "because": "bɪkˈɔz", "turn": "tˈɜɹn",
    "here": "hˈɪɹ", "why": "wˈI", "ask": "ˈæsk", "went": "wˈɛnt",
    "men": "mˈɛn", "read": "ɹˈid", "need": "nˈid", "land": "lˈænd",
    "different": "dˈɪfɹənt", "home": "hˈOm", "us": "ˈʌs", "move": "mˈuv",
    "try": "tɹˈI", "kind": "kˈInd", "hand": "hˈænd", "picture": "pˈɪkʧəɹ",
    "again": "əɡˈɛn", "change": "ʧˈAnʤ", "off": "ˈɔf", "play": "plˈA",
    "spell": "spˈɛl", "air": "ˈɛɹ", "away": "əwˈA", "animal": "ˈænəməl",
    "house": "hˈWs", "point": "pˈɔInt", "page": "pˈAʤ", "letter": "lˈɛɾəɹ",
    "mother": "mˈʌðəɹ", "answer": "ˈænsəɹ", "found": "fˈWnd",
    "study": "stˈʌdi", "still": "stˈɪl", "learn": "lˈɜɹn",
    "should": "ʃˈʊd", "world": "wˈɜɹld", "high": "hˈI", "every": "ˈɛvɹi",
    "near": "nˈɪɹ", "add": "ˈæd", "food": "fˈud", "between": "bɪtwˈin",
    "own": "ˈOn", "below": "bɪlˈO", "country": "kˈʌntɹi", "plant": "plˈænt",
    "last": "lˈæst", "school": "skˈul", "father": "fˈɑðəɹ", "keep": "kˈip",
    "tree": "tɹˈi", "never": "nˈɛvəɹ", "start": "stˈɑɹt", "city": "sˈɪɾi",
    "earth": "ˈɜɹθ", "eye": "ˈI", "light": "lˈIt", "thought": "θˈɔt",
    "head": "hˈɛd", "under": "ˈʌndəɹ", "story": "stˈɔɹi", "saw": "sˈɔ",
    "left": "lˈɛft", "don't": "dˈOnt", "few": "fjˈu", "while": "wˈIl",
    "along": "əlˈɔŋ", "might": "mˈIt", "close": "klˈOs",
    "something": "sˈʌmθɪŋ", "seem": "sˈim", "next": "nˈɛkst",
    "hard": "hˈɑɹd", "open": "ˈOpən", "example": "ɪɡzˈæmpəl",
    "begin": "bɪɡˈɪn", "life": "lˈIf", "always": "ˈɔlwAz",
    "those": "ðˈOz", "both": "bˈOθ", "paper": "pˈApəɹ",
    "together": "təɡˈɛðəɹ", "got": "ˈɡɑt", "group": "ɡɹˈup",
    "often": "ˈɔfən", "run": "ɹˈʌn", "hello": "həlˈO", "world's": "wˈɜɹldz",
    "quick": "kwˈɪk", "brown": "bɹˈWn", "fox": "fˈɑks", "jumps": "ʤˈʌmps",
    "lazy": "lˈAzi", "dog": "dˈɔɡ", "test": "tˈɛst", "speech": "spˈiʧ",
    "synthesis": "sˈɪnθəsɪs", "audio": "ˈɔdiO", "model": "mˈɑdəl",
    "maybe": "mˈAbi", "once": "wˈʌns", "woman": "wˈʊmən",
    "women": "wˈɪmɪn", "friend": "fɹˈɛnd", "sure": "ʃˈʊɹ",
    "pretty": "pɹˈɪɾi", "busy": "bˈɪzi", "done": "dˈʌn", "gone": "ɡˈɔn",
    "love": "lˈʌv", "above": "əbˈʌv", "enough": "ɪnˈʌf",
    "young": "jˈʌŋ", "touch": "tˈʌʧ", "heart": "hˈɑɹt", "says": "sˈɛz",
    "month": "mˈʌnθ", "nothing": "nˈʌθɪŋ", "someone": "sˈʌmwʌn",
    "island": "ˈIlənd", "hour": "ˈWɹ", "honest": "ˈɑnəst",
    "listen": "lˈɪsən", "often": "ˈɔfən", "beautiful": "bjˈuɾəfəl",
    "language": "lˈæŋɡwɪʤ", "machine": "məʃˈin", "today": "tədˈA",
    "tomorrow": "təmˈɑɹO", "minute": "mˈɪnɪt", "business": "bˈɪznəs",
    "question": "kwˈɛsʧən", "course": "kˈɔɹs", "against": "əɡˈɛnst",
}

# Digraph / context rules applied left-to-right for OOV words. Longest
# match wins (list is ordered longest-first within overlaps). The engine
# additionally special-cases soft c/g, positional y, magic-e lengthening
# and initial kn-/wr-/gn- before this table applies.
_RULES: List[Tuple[str, str]] = [
    ("ought", "ɔt"), ("aught", "ɔt"),
    ("tion", "ʃən"), ("sion", "ʒən"), ("cian", "ʃən"), ("tial", "ʃəl"),
    ("cial", "ʃəl"), ("ture", "ʧəɹ"), ("sure", "ʒəɹ"), ("ough", "ʌf"),
    ("igh", "I"), ("eigh", "A"), ("tch", "ʧ"), ("dge", "ʤ"),
    ("ing", "ɪŋ"), ("qu", "kw"), ("squ", "skw"),
    ("ch", "ʧ"), ("sh", "ʃ"), ("th", "θ"), ("ph", "f"), ("wh", "w"),
    ("ck", "k"), ("ng", "ŋ"),
    # double consonants
    ("bb", "b"), ("dd", "d"), ("ff", "f"), ("gg", "ɡ"), ("ll", "l"),
    ("mm", "m"), ("nn", "n"), ("pp", "p"), ("rr", "ɹ"), ("ss", "s"),
    ("tt", "t"), ("zz", "z"),
    # r-controlled and vowel teams
    ("air", "ɛɹ"), ("are", "ɛɹ"), ("ear", "ɪɹ"), ("eer", "ɪɹ"),
    ("ore", "ɔɹ"), ("oor", "ɔɹ"), ("our", "ɔɹ"),
    ("ar", "ɑɹ"), ("er", "əɹ"), ("ir", "ɜɹ"), ("or", "ɔɹ"), ("ur", "ɜɹ"),
    ("ee", "i"), ("oo", "u"), ("ea", "i"), ("ai", "A"), ("ay", "A"),
    ("oa", "O"), ("ow", "O"), ("ou", "W"), ("oi", "ɔI"), ("oy", "ɔI"),
    ("au", "ɔ"), ("aw", "ɔ"), ("ew", "u"), ("ue", "u"), ("ui", "u"),
    ("ie", "i"), ("ei", "A"), ("ey", "A"),
    # magic-e lengthened vowels (substituted by the engine)
    ("ā", "A"), ("ē", "i"), ("ī", "I"), ("ō", "O"), ("ū", "u"),
    # context markers injected by _respell (soft c/g, positional y)
    ("ç", "s"), ("ĝ", "ʤ"), ("ĵ", "j"), ("ŷ", "i"), ("ï", "ɪ"),
    # single letters
    ("a", "æ"), ("b", "b"), ("c", "k"), ("d", "d"), ("e", "ɛ"),
    ("f", "f"), ("g", "ɡ"), ("h", "h"), ("i", "ɪ"), ("j", "ʤ"),
    ("k", "k"), ("l", "l"), ("m", "m"), ("n", "n"), ("o", "ɑ"),
    ("p", "p"), ("r", "ɹ"), ("s", "s"), ("t", "t"), ("u", "ʌ"),
    ("v", "v"), ("w", "w"), ("x", "ks"), ("y", "j"), ("z", "z"),
]

_VOICELESS = set("ptkfθsʃʧh")
_SIBILANT = set("szʃʒʧʤ")


def _plural(ps: str) -> str:
    """Voicing-aware -s/-es/-'s (cats→s, dogs→z, wishes→ɪz)."""
    last = ps[-1] if ps else ""
    if last in _SIBILANT:
        return ps + "ɪz"
    if last in _VOICELESS:
        return ps + "s"
    return ps + "z"


def _past(ps: str) -> str:
    """Voicing-aware -ed (liked→t, loved→d, wanted→ɪd)."""
    last = ps[-1] if ps else ""
    if last in "td":
        return ps + "ɪd"
    if last in _VOICELESS:
        return ps + "t"
    return ps + "d"

_NUM_WORDS = {
    "0": "zero", "1": "one", "2": "two", "3": "three", "4": "four",
    "5": "five", "6": "six", "7": "seven", "8": "eight", "9": "nine",
}


class BasicEnglishG2P:
    """Lexicon + morphology + letter-rule fallback G2P (stand-in for
    misaki's en.G2P).

    Resolution order per word: big lexicon (CMUdict-scale when available
    — see lexicon.find_lexicon: MLX_AUDIO_TPU_LEXICON env / prebuilt
    data file / nltk corpus) → built-in irregulars → morphological
    decomposition (voicing-aware -s/-ed/-ing/-ly/-er/… over lexicon
    bases) → context-aware letter-to-sound rules (soft c/g, positional
    y, magic-e lengthening, silent kn-/wr-/gn-/-mb)."""

    def __init__(self, british: bool = False):
        self.british = british
        from .lexicon import find_lexicon

        self.lexicon = dict(_LEXICON)
        big = find_lexicon()
        if big:
            self.lexicon.update(big)
        self._cache: dict = {}

    # -- morphology ----------------------------------------------------

    def _morph(self, lw: str) -> Optional[str]:
        """Suffix-stripped lexicon lookup with phonological composition."""
        cand: List[Tuple[str, callable]] = []
        if lw.endswith("'s"):
            cand.append((lw[:-2], _plural))
        if lw.endswith("s'"):
            cand.append((lw[:-2], _plural))
        if lw.endswith("es"):
            cand.append((lw[:-2], _plural))
            cand.append((lw[:-1], _plural))  # e.g. "makes" → "make"
        elif lw.endswith("s") and not lw.endswith("ss"):
            cand.append((lw[:-1], _plural))
        if lw.endswith("ed"):
            cand.append((lw[:-2], _past))
            cand.append((lw[:-1], _past))  # "liked" → "like"
            if len(lw) > 4 and lw[-3] == lw[-4]:
                cand.append((lw[:-3], _past))  # "stopped" → "stop"
        if lw.endswith("ing"):
            cand.append((lw[:-3], lambda ps: ps + "ɪŋ"))
            cand.append((lw[:-3] + "e", lambda ps: ps + "ɪŋ"))  # making
            if len(lw) > 5 and lw[-4] == lw[-5]:
                cand.append((lw[:-4], lambda ps: ps + "ɪŋ"))  # running
        for suf, tail in (("ly", "li"), ("er", "əɹ"), ("est", "əst"),
                          ("ness", "nəs"), ("ment", "mənt"),
                          ("ful", "fəl"), ("less", "ləs")):
            if lw.endswith(suf):
                base = lw[: -len(suf)]
                cand.append((base, lambda ps, t=tail: ps + t))
                if suf in ("er", "est"):  # "nicer" → "nice"
                    cand.append((base + "e", lambda ps, t=tail: ps + t))
                if base.endswith("i"):  # "happily" → "happy"
                    cand.append((base[:-1] + "y",
                                 lambda ps, t=tail: ps + t))
        for base, fn in cand:
            ps = self.lexicon.get(base)
            if ps:
                return fn(ps)
        # no lexicon base: still decompose clear suffixes so voicing and
        # stem spelling rules (doubling, silent e) apply to the LTS base
        for suf in ("ing", "ed", "es", "ly", "ness", "ment", "ful",
                    "less"):
            if lw.endswith(suf) and len(lw) - len(suf) >= 3:
                base = lw[: -len(suf)]
                if len(base) > 2 and base[-1] == base[-2]:
                    base = base[:-1]  # stopped → stop
                ps = self._letters_to_sound(base)
                if suf == "ing":
                    return ps + "ɪŋ"
                if suf == "ed":
                    return _past(ps)
                if suf == "es":
                    return _plural(ps)
                return ps + {"ly": "li", "ness": "nəs", "ment": "mənt",
                             "ful": "fəl", "less": "ləs"}[suf]
        return None

    # -- letter-to-sound -----------------------------------------------

    @staticmethod
    def _respell(lw: str) -> str:
        """Context transforms before the rule table: silent letters,
        soft c/g, positional y, magic-e lengthening."""
        # silent initial clusters / final -mb
        if lw.startswith("kn"):
            lw = lw[1:]
        if lw.startswith("wr"):
            lw = lw[1:]
        if lw.startswith("gn"):
            lw = lw[1:]
        if lw.endswith("mb"):
            lw = lw[:-1]
        # magic-e: V-C-e ending lengthens the vowel, e silent (except for
        # the -ture/-sure suffixes, whose rules must see the raw spelling)
        long_map = {"a": "ā", "e": "ē", "i": "ī", "o": "ō", "u": "ū",
                    "y": "ī"}
        if lw.endswith(("ture", "sure")):
            pass
        elif (len(lw) >= 4 and lw[-1] == "e" and lw[-2] not in "aeiouwy"
                and lw[-3] in long_map and lw[-4] not in "aeiou"):
            lw = lw[:-3] + long_map[lw[-3]] + lw[-2]
        elif len(lw) > 3 and lw.endswith("e") and lw[-2] not in "aeiou":
            lw = lw[:-1]  # other silent final e
        out = []
        for i, c in enumerate(lw):
            nxt = lw[i + 1] if i + 1 < len(lw) else ""
            if c == "c" and nxt in ("e", "i", "y", "ē", "ī"):
                out.append("ç")
            elif c == "g" and nxt in ("e", "y"):
                out.append("ĝ")
            elif c == "y":
                prev = lw[i - 1] if i > 0 else ""
                if prev in "aeiou":
                    out.append("y")  # vowel team (ay/ey/oy rules)
                elif i == 0:
                    out.append("ĵ")
                elif i == len(lw) - 1:
                    out.append("ŷ")
                else:
                    out.append("ï")
            else:
                out.append(c)
        return "".join(out)

    def _letters_to_sound(self, lw: str) -> str:
        lw = self._respell(lw)
        out = []
        i = 0
        while i < len(lw):
            for pat, ph in _RULES:
                if lw.startswith(pat, i):
                    out.append(ph)
                    i += len(pat)
                    break
            else:
                i += 1  # unmapped character (apostrophes etc.)
        ps = "".join(out)
        # put primary stress before first vowel-ish symbol
        for j, ch in enumerate(ps):
            if ch in "æɑɔɛɪʊʌəiuAIOWɜ":
                ps = ps[:j] + "ˈ" + ps[j:]
                break
        return ps

    def _word_to_phonemes(self, word: str) -> str:
        lw = word.lower()
        hit = self._cache.get(lw)
        if hit is not None:
            return hit
        ps = (self.lexicon.get(lw) or self._morph(lw)
              or self._letters_to_sound(lw))
        self._cache[lw] = ps
        return ps

    def __call__(self, text: str):
        tokens: List[PhonemeToken] = []
        pieces = re.findall(r"[A-Za-z']+|\d+|[^\sA-Za-z\d]+|\s+", text)
        i = 0
        while i < len(pieces):
            p = pieces[i]
            if p.isspace():
                if tokens:
                    tokens[-1].whitespace = " "
                i += 1
                continue
            if p[0].isdigit():
                words = [_NUM_WORDS.get(d, "") for d in p]
                ph = " ".join(self._word_to_phonemes(w) for w in words if w)
            elif re.match(r"[A-Za-z']", p):
                ph = self._word_to_phonemes(p)
            else:
                # punctuation maps through when in the vocab
                ph = "".join(c for c in p if c in '!"(),.:;?—…“”')
            tokens.append(PhonemeToken(text=p, phonemes=ph, whitespace=""))
            i += 1
        phoneme_str = "".join(
            (t.phonemes or "") + t.whitespace for t in tokens
        ).strip()
        return phoneme_str, tokens


class _MisakiG2P:
    def __init__(self, british: bool):
        from misaki import en  # type: ignore

        fallback = None
        try:
            from misaki import espeak  # type: ignore

            fallback = espeak.EspeakFallback(british=british)
        except Exception:
            pass
        self._g2p = en.G2P(trf=False, british=british, fallback=fallback, unk="")

    def __call__(self, text: str):
        result, tokens = self._g2p(text)
        out = [
            PhonemeToken(
                text=t.text, phonemes=t.phonemes, whitespace=t.whitespace
            )
            for t in tokens
        ]
        return result, out


def get_g2p(lang_code: str):
    """Best available G2P for the language: misaki → builtin fallback."""
    british = lang_code == "b"
    if lang_code in "ab":
        try:
            return _MisakiG2P(british)
        except ImportError:
            import logging

            logging.getLogger(__name__).warning(
                "misaki is not installed — Kokoro is using the built-in "
                "basic English G2P fallback (reduced pronunciation "
                "quality; lexicon of ~130 words + letter rules). Install "
                "misaki for production-quality phonemization."
            )
            return BasicEnglishG2P(british)
    # Non-English languages need espeak/misaki extras; raise a clear error.
    try:
        return _MisakiG2P(False)
    except ImportError as e:
        raise ImportError(
            f"G2P for lang_code={lang_code!r} requires misaki/espeak extras"
        ) from e
