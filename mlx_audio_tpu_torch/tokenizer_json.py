"""A reader of Hugging Face `tokenizer.json` files for byte-level BPE.

The port's counterpart of what the JAX package gets from
`tokenizers.Tokenizer.from_file` (Whisper) and `AutoTokenizer` (Qwen3-TTS's
Qwen2 text tokenizer), written against the `tokenizers` library's semantics
and held to it by the tests. It needs neither `tokenizers` nor
`transformers`, which the card's machine does not have.

It covers exactly the components Whisper's, Qwen2's and Llama-3's files
use:

- model: `BPE`, merges written as "a b" strings or as pairs, `ignore_merges`,
  `unk_token` / `fuse_unk`;
- normalizer: null, `NFC`, or a `Sequence` of them;
- pre-tokenizer: `ByteLevel` (with or without the GPT-2 pattern), and a
  `Sequence` of `Split(Regex, "Isolated")` and `ByteLevel(use_regex=False)`
  with Qwen2's pattern or Llama-3's (Qwen2's with runs of up to three
  digits);
- decoder: `ByteLevel`;
- post-processor: `ByteLevel`, null, `TemplateProcessing` (single), or a
  `Sequence` of them with at most one template (Llama-3's);
- `added_tokens`, split out before pre-tokenizing, with `special`,
  `lstrip`, `rstrip` and `normalized`.

Any other component raises and names itself. The split patterns use
`\\p{L}` and `\\p{N}`, which neither `re` nor the card has; they run here as
small scanners over `unicodedata.category` that follow each pattern's
alternation order, backtracking included.
"""

from __future__ import annotations

import functools
import heapq
import json
import unicodedata
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

__all__ = ["Tokenizer", "load", "GPT2_PATTERN", "QWEN2_PATTERN", "LLAMA3_PATTERN",
           "bytes_to_unicode"]

# Unicode White_Space: Rust's `char::is_whitespace` and Oniguruma's `\s`
# (str.isspace would add U+001C..U+001F)
WHITE_SPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
    + "".join(chr(c) for c in range(0x2000, 0x200B)))

GPT2_PATTERN = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
                 r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
                  r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")


@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's map of the 256 bytes onto printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


# ---------------------------------------------------------------------------
# The split patterns
# ---------------------------------------------------------------------------


def _letter(c: str) -> bool:
    return unicodedata.category(c)[0] == "L"


def _number(c: str) -> bool:
    return unicodedata.category(c)[0] == "N"


def _other(c: str) -> bool:
    """[^\\s\\p{L}\\p{N}]"""
    return c not in WHITE_SPACE and unicodedata.category(c)[0] not in "LN"


def _run(text: str, i: int, pred) -> int:
    n = len(text)
    while i < n and pred(text[i]):
        i += 1
    return i


def _opt_prefix_run(text: str, i: int, prefix, body) -> int:
    """`P?B+` at i, the optional prefix taken greedily: the match's end, or
    -1."""
    n = len(text)
    if i + 1 < n and prefix(text[i]) and body(text[i + 1]):
        return _run(text, i + 1, body)
    if i < n and body(text[i]):
        return _run(text, i, body)
    return -1


def _space_tail(text: str, i: int) -> int:
    """`\\s+(?!\\S)|\\s+` at i: a whitespace run, less its last character when
    a non-space follows it and the run is longer than one."""
    j = _run(text, i, WHITE_SPACE.__contains__)
    if j == i:
        return -1
    if j == len(text) or j - 1 == i:
        return j  # at the end, or a single space before \S: the second branch
    return j - 1


_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
# Oniguruma's (?i) folds these too: U+017F LATIN SMALL LETTER LONG S is s
_FOLD = {"ſ": "s"}


def _contraction(text: str, i: int, ignore_case: bool) -> int:
    if text[i] != "'":
        return -1
    for c in _CONTRACTIONS:
        piece = text[i + 1:i + 1 + len(c)]
        if ignore_case:
            piece = "".join(_FOLD.get(ch, ch.lower() if ch.isascii() else ch) for ch in piece)
        if piece == c:
            return i + 1 + len(c)
    return -1


def _scan_gpt2(text: str, i: int) -> int:
    """`'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+`"""
    end = _contraction(text, i, ignore_case=False)
    if end > 0:
        return end
    space = " ".__eq__
    for body in (_letter, _number, _other):
        end = _opt_prefix_run(text, i, space, body)
        if end > 0:
            return end
    return _space_tail(text, i)


def _not_crlf_letter_number(c: str) -> bool:
    return c not in "\r\n" and unicodedata.category(c)[0] not in "LN"


def _scan_qwen2(text: str, i: int, digits: int = 1) -> int:
    """`(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\\r\\n\\p{L}\\p{N}]?\\p{L}+|\\p{N}
    | ?[^\\s\\p{L}\\p{N}]+[\\r\\n]*|\\s*[\\r\\n]+|\\s+(?!\\S)|\\s+`, with
    `\\p{N}{1,digits}` for the third branch (Llama-3's: 3)."""
    end = _contraction(text, i, ignore_case=True)
    if end > 0:
        return end
    end = _opt_prefix_run(text, i, _not_crlf_letter_number, _letter)
    if end > 0:
        return end
    if _number(text[i]):
        return min(_run(text, i, _number), i + digits)
    end = _opt_prefix_run(text, i, " ".__eq__, _other)
    if end > 0:
        return _run(text, end, "\r\n".__contains__)
    # \s*[\r\n]+: the greedy \s* gives back to the run's last \r or \n
    j = _run(text, i, WHITE_SPACE.__contains__)
    last = max(text.rfind("\r", i, j), text.rfind("\n", i, j))
    if last >= 0:
        return last + 1
    return _space_tail(text, i)


_SCANNERS = {GPT2_PATTERN: _scan_gpt2, QWEN2_PATTERN: _scan_qwen2,
             LLAMA3_PATTERN: functools.partial(_scan_qwen2, digits=3)}


def _split_isolated(text: str, scan: Callable[[str, int], int]) -> List[str]:
    """Regex `find_iter` with the matches kept as pieces of their own, and
    the text between matches as pieces too."""
    out, gap, i, n = [], 0, 0, len(text)
    while i < n:
        end = scan(text, i)
        if end <= i:
            i += 1
            continue
        if gap < i:
            out.append(text[gap:i])
        out.append(text[i:end])
        gap = i = end
    if gap < n:
        out.append(text[gap:])
    return out


# ---------------------------------------------------------------------------
# Components
# ---------------------------------------------------------------------------


def _unsupported(path, what: str, spec) -> ValueError:
    return ValueError(f"{path}: unsupported {what} {json.dumps(spec)[:200]} (the reader "
                      "covers byte-level BPE as Whisper's, Qwen2's and Llama-3's files use it)")


def _normalizer(spec, path) -> Callable[[str], str]:
    if spec is None:
        return lambda s: s
    kind = spec.get("type")
    if kind == "NFC":
        return lambda s: unicodedata.normalize("NFC", s)
    if kind == "Sequence":
        steps = [_normalizer(s, path) for s in spec.get("normalizers", [])]
        return lambda s: functools.reduce(lambda acc, f: f(acc), steps, s)
    raise _unsupported(path, "normalizer", spec)


def _byte_level_step(spec, path) -> Callable[[str], List[str]]:
    # trim_offsets moves offsets only: no effect on the ids
    use_regex = spec.get("use_regex", True)
    prefix = spec.get("add_prefix_space", False)

    def step(piece: str) -> List[str]:
        if prefix and not piece.startswith(" "):
            piece = " " + piece
        return _split_isolated(piece, _scan_gpt2) if use_regex else [piece]

    return step


def _pre_tokenizer(spec, path) -> Tuple[List[Callable[[str], List[str]]], bool]:
    """(the split steps in order, whether a ByteLevel step maps the bytes)."""
    if spec is None:
        return [], False
    kind = spec.get("type")
    if kind == "ByteLevel":
        return [_byte_level_step(spec, path)], True
    if kind == "Split":
        pattern = spec.get("pattern", {})
        scan = _SCANNERS.get(pattern.get("Regex"))
        if scan is None or spec.get("behavior") != "Isolated" or spec.get("invert", False):
            raise _unsupported(path, "Split pre-tokenizer", spec)
        return [lambda piece: _split_isolated(piece, scan)], False
    if kind == "Sequence":
        steps, byte_level = [], False
        for sub in spec.get("pretokenizers", []):
            s, b = _pre_tokenizer(sub, path)
            if byte_level and s:
                raise _unsupported(path, "pre-tokenizer after ByteLevel", sub)
            steps += s
            byte_level = byte_level or b
        return steps, byte_level
    raise _unsupported(path, "pre-tokenizer", spec)


class _AddedToken:
    __slots__ = ("content", "id", "special", "lstrip", "rstrip", "normalized")

    def __init__(self, spec: dict, path):
        if spec.get("single_word", False):
            raise _unsupported(path, "added token (single_word)", spec)
        self.content = spec["content"]
        self.id = int(spec["id"])
        self.special = bool(spec.get("special", False))
        self.lstrip = bool(spec.get("lstrip", False))
        self.rstrip = bool(spec.get("rstrip", False))
        self.normalized = bool(spec.get("normalized", not self.special))


class _Matcher:
    """Aho-Corasick with leftmost-longest matching, as `tokenizers` splits
    out added tokens: at the leftmost position where any token matches, the
    longest one."""

    def __init__(self, tokens: Dict[str, _AddedToken]):
        self.by_first: Dict[str, List[Tuple[str, _AddedToken]]] = {}
        for content, tok in tokens.items():
            if content:
                self.by_first.setdefault(content[0], []).append((content, tok))
        for cands in self.by_first.values():
            cands.sort(key=lambda ct: -len(ct[0]))

    def split(self, text: str) -> List[Tuple[str, Optional[_AddedToken]]]:
        """The text cut into (piece, None) and (token text, token) runs."""
        if not self.by_first:
            return [(text, None)]
        out: List[Tuple[str, Optional[_AddedToken]]] = []
        start = i = 0
        n = len(text)
        while i < n:
            cands = self.by_first.get(text[i])
            hit = None
            if cands:
                hit = next(((c, t) for c, t in cands if text.startswith(c, i)), None)
            if hit is None:
                i += 1
                continue
            content, tok = hit
            lo, hi = i, i + len(content)
            if tok.lstrip:
                while lo > start and text[lo - 1] in WHITE_SPACE:
                    lo -= 1
            if tok.rstrip:
                while hi < n and text[hi] in WHITE_SPACE:
                    hi += 1
            if start < lo:
                out.append((text[start:lo], None))
            out.append((text[lo:hi], tok))
            start = i = hi
        if start < n:
            out.append((text[start:], None))
        return out


class _BPE:
    def __init__(self, spec: dict, path):
        if spec.get("type") != "BPE":
            raise _unsupported(path, "model", {"type": spec.get("type")})
        for key in ("dropout", "continuing_subword_prefix", "end_of_word_suffix"):
            if spec.get(key):
                raise _unsupported(path, f"BPE option {key}", spec[key])
        if spec.get("byte_fallback", False):
            raise _unsupported(path, "BPE option byte_fallback", True)
        self.vocab: Dict[str, int] = dict(spec["vocab"])
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        unk = spec.get("unk_token")
        self.unk_id = self.vocab[unk] if unk is not None else None
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(spec.get("merges", [])):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            try:
                pair = (self.vocab[a], self.vocab[b])
                new_id = self.vocab[a + b]
            except KeyError as e:
                raise ValueError(f"{path}: merge {m!r} names a token outside the vocabulary "
                                 f"({e})") from None
            self.merges.setdefault(pair, (rank, new_id))
        self._cache: Dict[str, List[int]] = {}

    def tokenize(self, word: str) -> List[int]:
        got = self._cache.get(word)
        if got is not None:
            return got
        if self.ignore_merges and word in self.vocab:
            ids = [self.vocab[word]]
        else:
            ids = self._merge(self._symbols(word))
        if len(self._cache) > 50_000:
            self._cache.clear()
        self._cache[word] = ids
        return ids

    def _symbols(self, word: str) -> List[int]:
        out: List[int] = []
        unk = False  # the last symbol added is an unknown one
        for ch in word:
            i = self.vocab.get(ch)
            if i is not None:
                out.append(i)
                unk = False
            elif self.unk_id is not None:
                if not (unk and self.fuse_unk):
                    out.append(self.unk_id)
                unk = True
        return out

    def _merge(self, sym: List[int]) -> List[int]:
        """`tokenizers`' `Word::merge_all`: pop the lowest (rank, position)
        pair, skip entries a merge made stale, push the pairs a merge
        forms with its neighbours."""
        n = len(sym)
        if n < 2:
            return sym
        nxt = list(range(1, n + 1))
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = self.merges.get((sym[i], sym[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _rank, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] >= n:
                continue
            right = nxt[pos]
            m = self.merges.get((sym[pos], sym[right]))
            if m is None or m[1] != new_id:
                continue
            sym[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[right] < n:
                prv[nxt[right]] = pos
            if prv[pos] >= 0:
                m = self.merges.get((sym[prv[pos]], new_id))
                if m is not None:
                    heapq.heappush(heap, (m[0], prv[pos], m[1]))
            if nxt[pos] < n:
                m = self.merges.get((new_id, sym[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [s for s, a in zip(sym, alive) if a]


def _post_processor(spec, path, token_to_id) -> Tuple[List[int], List[int]]:
    """(ids before, ids after) the sequence when special tokens are added."""
    if spec is None or spec.get("type") == "ByteLevel":
        return [], []
    if spec.get("type") == "Sequence":
        parts = [_post_processor(p, path, token_to_id) for p in spec.get("processors", [])]
        templates = [p for p in parts if p != ([], [])]
        if len(templates) > 1:
            raise _unsupported(path, "post-processor sequence of several templates", spec)
        return templates[0] if templates else ([], [])
    if spec.get("type") == "TemplateProcessing":
        special = spec.get("special_tokens", {})
        before: List[int] = []
        after: List[int] = []
        seen_a = False
        for item in spec.get("single", []):
            if "Sequence" in item:
                if item["Sequence"].get("id") != "A" or seen_a:
                    raise _unsupported(path, "template item", item)
                seen_a = True
            elif "SpecialToken" in item:
                name = item["SpecialToken"]["id"]
                ids = special[name]["ids"] if name in special else [token_to_id(name)]
                (after if seen_a else before).extend(int(i) for i in ids)
            else:
                raise _unsupported(path, "template item", item)
        return before, after
    raise _unsupported(path, "post-processor", spec)


def _decoder(spec, path) -> Callable[[List[str]], str]:
    if (spec or {}).get("type") != "ByteLevel":
        raise _unsupported(path, "decoder", spec)
    char_bytes = {c: b for b, c in bytes_to_unicode().items()}

    def decode(tokens: List[str]) -> str:
        out = bytearray()
        for t in tokens:
            try:
                out.extend(char_bytes[c] for c in t)
            except KeyError:  # a token outside the byte alphabet: its UTF-8
                out.extend(t.encode("utf-8"))
        return out.decode("utf-8", errors="replace")

    return decode


# ---------------------------------------------------------------------------
# The tokenizer
# ---------------------------------------------------------------------------


class Tokenizer:
    """`tokenizer.json` for byte-level BPE, with the surface the port's
    callers use: `encode`, `decode`, `token_to_id`, `id_to_token` (the
    `tokenizers.Tokenizer` names; `encode` returns the ids, as
    `AutoTokenizer.encode` does)."""

    def __init__(self, spec: dict, path: Union[str, Path] = "tokenizer.json"):
        for key in ("truncation", "padding"):
            if spec.get(key) is not None:
                raise _unsupported(path, key, spec[key])
        self.path = str(path)
        self.model = _BPE(spec.get("model", {}), path)
        self._normalize = _normalizer(spec.get("normalizer"), path)
        self._pre_steps, byte_level = _pre_tokenizer(spec.get("pre_tokenizer"), path)
        if not byte_level:
            raise _unsupported(path, "pre-tokenizer without ByteLevel",
                               spec.get("pre_tokenizer"))
        self._byte_map = bytes_to_unicode()
        self._decode_tokens = _decoder(spec.get("decoder"), path)
        added = [_AddedToken(t, path) for t in spec.get("added_tokens", [])]
        self._check_added_ids(added)
        self._added_by_id = {t.id: t for t in added}
        self._added_by_content = {t.content: t for t in added}
        self._special = {t.content for t in added if t.special}
        self._raw = _Matcher({t.content: t for t in added if not t.normalized})
        self._norm = _Matcher({self._normalize(t.content): t for t in added if t.normalized})
        self._id_to_token = {i: t for t, i in self.model.vocab.items()}
        self._before, self._after = _post_processor(spec.get("post_processor"), path,
                                                    self._require_id)

    def _check_added_ids(self, added: List[_AddedToken]) -> None:
        """`tokenizers` gives an added token outside the model's vocabulary
        the next id after the largest so far, whatever the file says: a file
        whose ids follow another rule reads differently there, so refuse
        it."""
        size = len(self.model.vocab)
        top = None
        for t in added:
            want = self.model.vocab.get(t.content)
            if want is None:
                want = size if top is None or (top < size and size) else top + 1
            top = want if top is None else max(top, want)
            if t.id != want:
                raise ValueError(f"{self.path}: added token {t.content!r} has id {t.id}; "
                                 f"`tokenizers` would give it {want}")

    @classmethod
    def from_file(cls, path: Union[str, Path]) -> "Tokenizer":
        path = Path(path)
        return cls(json.loads(path.read_text(encoding="utf-8")), path)

    # ---- vocabulary ----

    def token_to_id(self, token: str) -> Optional[int]:
        t = self._added_by_content.get(token)
        return t.id if t is not None else self.model.vocab.get(token)

    def _require_id(self, token: str) -> int:
        i = self.token_to_id(token)
        if i is None:
            raise ValueError(f"{self.path}: the template names {token!r}, which has no id")
        return i

    def id_to_token(self, i: int) -> Optional[str]:
        t = self._added_by_id.get(int(i))
        return t.content if t is not None else self._id_to_token.get(int(i))

    def get_vocab_size(self, with_added_tokens: bool = True) -> int:
        ids = set(self._id_to_token)
        if with_added_tokens:
            ids |= set(self._added_by_id)
        return len(ids)

    # ---- encode ----

    def _pieces(self, text: str) -> Iterable[Union[int, str]]:
        """Added-token ids and pre-tokenized words (byte-mapped), in order."""
        for raw, tok in self._raw.split(text):
            if tok is not None:
                yield tok.id
                continue
            for piece, ntok in self._norm.split(self._normalize(raw)):
                if ntok is not None:
                    yield ntok.id
                    continue
                words = [piece]
                for step in self._pre_steps:
                    words = [w for word in words for w in step(word) if w]
                for w in words:
                    yield "".join(self._byte_map[b] for b in w.encode("utf-8"))

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids: List[int] = list(self._before) if add_special_tokens else []
        if text:
            for p in self._pieces(text):
                if isinstance(p, int):
                    ids.append(p)
                else:
                    ids.extend(self.model.tokenize(p))
        if add_special_tokens:
            ids.extend(self._after)
        return ids

    # ---- decode ----

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        tokens = []
        for i in ids:
            t = self.id_to_token(int(i))
            if t is None or (skip_special_tokens and t in self._special):
                continue
            tokens.append(t)
        return self._decode_tokens(tokens)


@functools.lru_cache(maxsize=8)
def _load(path: str, mtime_ns: int, size: int) -> Tokenizer:
    return Tokenizer.from_file(path)


def load(path: Union[str, Path]) -> Tokenizer:
    """`Tokenizer.from_file`, parsed once per file version: a server builds a
    tokenizer per request, and a 150k-token vocabulary takes a while to
    parse in Python."""
    p = Path(path)
    if p.is_dir():
        p = p / "tokenizer.json"
    st = p.stat()
    return _load(str(p.resolve()), st.st_mtime_ns, st.st_size)
