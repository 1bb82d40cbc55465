"""Whisper tokenizer wrapper (a copy of `mlx_audio_tpu/stt/models/whisper/tokenizer.py`,
kept here so the port never imports the JAX package).

Loads `tokenizer.json` from the checkpoint dir through the port's own reader
(`tokenizer_json`), which needs no `tokenizers` library; the JAX package
reads the same file with `tokenizers`. Special-token ids are resolved by
name; a DummyTokenizer with the same interface backs the tests and the
random-weight runs.
"""

from __future__ import annotations

from functools import cached_property
from typing import List, Optional, Sequence, Tuple

LANGUAGES = {
    "en": "english", "zh": "chinese", "de": "german", "es": "spanish",
    "ru": "russian", "ko": "korean", "fr": "french", "ja": "japanese",
    "pt": "portuguese", "tr": "turkish", "pl": "polish", "ca": "catalan",
    "nl": "dutch", "ar": "arabic", "sv": "swedish", "it": "italian",
    "id": "indonesian", "hi": "hindi", "fi": "finnish", "vi": "vietnamese",
    "he": "hebrew", "uk": "ukrainian", "el": "greek", "ms": "malay",
    "cs": "czech", "ro": "romanian", "da": "danish", "hu": "hungarian",
    "ta": "tamil", "no": "norwegian", "th": "thai", "ur": "urdu",
    "hr": "croatian", "bg": "bulgarian", "lt": "lithuanian", "la": "latin",
    "mi": "maori", "ml": "malayalam", "cy": "welsh", "sk": "slovak",
    "te": "telugu", "fa": "persian", "lv": "latvian", "bn": "bengali",
    "sr": "serbian", "az": "azerbaijani", "sl": "slovenian", "kn": "kannada",
    "et": "estonian", "mk": "macedonian", "br": "breton", "eu": "basque",
    "is": "icelandic", "hy": "armenian", "ne": "nepali", "mn": "mongolian",
    "bs": "bosnian", "kk": "kazakh", "sq": "albanian", "sw": "swahili",
    "gl": "galician", "mr": "marathi", "pa": "punjabi", "si": "sinhala",
    "km": "khmer", "sn": "shona", "yo": "yoruba", "so": "somali",
    "af": "afrikaans", "oc": "occitan", "ka": "georgian", "be": "belarusian",
    "tg": "tajik", "sd": "sindhi", "gu": "gujarati", "am": "amharic",
    "yi": "yiddish", "lo": "lao", "uz": "uzbek", "fo": "faroese",
    "ht": "haitian creole", "ps": "pashto", "tk": "turkmen", "nn": "nynorsk",
    "mt": "maltese", "sa": "sanskrit", "lb": "luxembourgish", "my": "myanmar",
    "bo": "tibetan", "tl": "tagalog", "mg": "malagasy", "as": "assamese",
    "tt": "tatar", "haw": "hawaiian", "ln": "lingala", "ha": "hausa",
    "ba": "bashkir", "jw": "javanese", "su": "sundanese", "yue": "cantonese",
}


class WhisperTokenizer:
    """tokenizer.json-backed tokenizer with whisper special-token helpers."""

    def __init__(self, model_path, multilingual: bool = True,
                 language: Optional[str] = "en", task: str = "transcribe"):
        from ....tokenizer_json import load

        self._tok = load(model_path)
        self.multilingual = multilingual
        self.language = language or "en"
        self.task = task

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, ids: Sequence[int]) -> str:
        ids = [i for i in ids if i < self.timestamp_begin]
        return self._tok.decode(list(ids), skip_special_tokens=True)

    def decode_with_timestamps(self, ids: Sequence[int]) -> str:
        out = []
        for t in ids:
            if t >= self.timestamp_begin:
                out.append(f"<|{(t - self.timestamp_begin) * 0.02:.2f}|>")
            else:
                out.append(self.decode([t]))
        return "".join(out)

    # ---- word splitting for word-level timestamps (timing.py) ----
    def split_to_word_tokens(self, tokens: Sequence[int]):
        if self.language in {"zh", "ja", "th", "lo", "my", "yue"}:
            return self.split_tokens_on_unicode(list(tokens))
        return self.split_tokens_on_spaces(list(tokens))

    def split_tokens_on_unicode(self, tokens: List[int]):
        decoded_full = self.decode_with_timestamps(tokens)
        replacement = "�"
        words, word_tokens, current = [], [], []
        offset = 0
        for token in tokens:
            current.append(token)
            decoded = self.decode_with_timestamps(current)
            if (replacement not in decoded
                    or decoded_full[offset + decoded.index(replacement)]
                    == replacement):
                words.append(decoded)
                word_tokens.append(current)
                current = []
                offset += len(decoded)
        return words, word_tokens

    def split_tokens_on_spaces(self, tokens: List[int]):
        subwords, subword_tokens = self.split_tokens_on_unicode(tokens)
        words, word_tokens = [], []
        for sub, toks in zip(subwords, subword_tokens):
            special = toks[0] >= self.eot
            with_space = sub.startswith(" ")
            punct = sub.strip() in "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"
            if special or with_space or punct or len(words) == 0:
                words.append(sub)
                word_tokens.append(list(toks))
            else:
                words[-1] += sub
                word_tokens[-1].extend(toks)
        return words, word_tokens

    def _id(self, token: str) -> int:
        i = self._tok.token_to_id(token)
        if i is None:
            raise KeyError(token)
        return i

    @cached_property
    def eot(self) -> int:
        return self._id("<|endoftext|>")

    @cached_property
    def sot(self) -> int:
        return self._id("<|startoftranscript|>")

    @cached_property
    def sot_prev(self) -> int:
        return self._id("<|startofprev|>")

    @cached_property
    def no_speech(self) -> int:
        for tok in ("<|nospeech|>", "<|nocaptions|>"):
            try:
                return self._id(tok)
            except KeyError:
                continue
        return self.eot

    @cached_property
    def no_timestamps(self) -> int:
        return self._id("<|notimestamps|>")

    @cached_property
    def timestamp_begin(self) -> int:
        return self._id("<|0.00|>")

    @cached_property
    def transcribe(self) -> int:
        return self._id("<|transcribe|>")

    @cached_property
    def translate(self) -> int:
        return self._id("<|translate|>")

    @cached_property
    def all_language_tokens(self) -> Tuple[int, ...]:
        out = []
        for code in LANGUAGES:
            try:
                out.append(self._id(f"<|{code}|>"))
            except KeyError:
                pass
        return tuple(out)

    @cached_property
    def all_language_codes(self) -> Tuple[str, ...]:
        out = []
        for code in LANGUAGES:
            try:
                self._id(f"<|{code}|>")
                out.append(code)
            except KeyError:
                pass
        return tuple(out)

    def to_language_token(self, language: str) -> int:
        return self._id(f"<|{language}|>")

    @cached_property
    def sot_sequence(self) -> Tuple[int, ...]:
        seq = [self.sot]
        if self.multilingual:
            seq.append(self.to_language_token(self.language))
            seq.append(self.transcribe if self.task == "transcribe" else self.translate)
        return tuple(seq)

    @property
    def sot_sequence_including_notimestamps(self) -> Tuple[int, ...]:
        return tuple(list(self.sot_sequence) + [self.no_timestamps])

    @cached_property
    def non_speech_tokens(self) -> Tuple[int, ...]:
        """Token ids to suppress: sounds/symbols that aren't speech
        (mirrors openai-whisper's list construction)."""
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
        symbols += (
            "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪"
        ).split()
        miscellaneous = set("♩♪♫♬♭♮♯")
        result = set()
        for symbol in symbols + list(miscellaneous):
            for tok in [symbol, " " + symbol]:
                ids = self.encode(tok)
                if len(ids) == 1:
                    result.add(ids[0])
        return tuple(sorted(result))


class DummyTokenizer:
    """Structural stand-in for unit tests (no vocab files needed)."""

    def __init__(self, n_vocab: int = 51865, language: str = "en",
                 task: str = "transcribe", multilingual: bool = True):
        self.eot = n_vocab - 1
        self.timestamp_begin = n_vocab - 1501
        self.no_timestamps = self.timestamp_begin - 1
        self.no_speech = self.timestamp_begin - 2
        self.sot_prev = self.timestamp_begin - 3
        self.translate = self.timestamp_begin - 4
        self.transcribe = self.timestamp_begin - 5
        self.sot = self.timestamp_begin - 6
        self.language = language
        self.task = task
        self.multilingual = multilingual
        self.all_language_tokens = tuple(range(self.sot + 1, self.sot + 3))
        self.all_language_codes = ("en", "es")
        self.non_speech_tokens = (5, 6, 7)

    @property
    def sot_sequence(self):
        return (self.sot, self.all_language_tokens[0], self.transcribe)

    @property
    def sot_sequence_including_notimestamps(self):
        return tuple(list(self.sot_sequence) + [self.no_timestamps])

    def to_language_token(self, language):
        return self.all_language_tokens[0]

    def encode(self, text):
        return [ord(c) % 100 + 10 for c in text]

    def decode(self, ids):
        return "".join(chr(97 + (i % 26)) for i in ids if i < self.timestamp_begin)

    def decode_with_timestamps(self, ids):
        return self.decode(ids)

    def split_to_word_tokens(self, tokens):
        # one "word" per pair of tokens — structural stand-in for tests
        words, word_tokens = [], []
        for i in range(0, len(tokens), 2):
            chunk = list(tokens[i: i + 2])
            words.append(" " + self.decode(chunk))
            word_tokens.append(chunk)
        return words, word_tokens
