"""A reader of Hugging Face `tokenizer.json` files for byte-level BPE and
for BERT's WordPiece.

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
- a character-level BPE with no byte mapping: the `Whitespace`
  pre-tokenizer (`\\w+|[^\\w\\s]+`) and no decoder (the tokens joined
  with spaces, as `tokenizers` joins them), as Chatterbox's English file is
  read here (its published file is not in the repository);
- post-processor: `ByteLevel`, null, `TemplateProcessing` (single), or a
  `Sequence` of them with at most one template (Llama-3's);
- `added_tokens`, split out before pre-tokenizing, with `special`,
  `lstrip`, `rstrip` and `normalized`.

WordPiece (`WordPieceTokenizer`, Bark's text: `bert-base-multilingual-cased`)
is read from a `tokenizer.json` whose model is `WordPiece` (`BertNormalizer`,
`BertPreTokenizer`, the `WordPiece` decoder, a `TemplateProcessing` or
`BertProcessing` post-processor) or from a bare `vocab.txt`. Its reference
is `transformers.BertTokenizer`, which the JAX package's Bark calls: where
`tokenizers` differs from it (`BertTokenizer` composes the text to NFC
before splitting it; `BertNormalizer` does not), `BertTokenizer` decides.

Any other component raises and names itself. The split patterns use
`\\p{L}` and `\\p{N}`, which neither `re` nor the card has; they run here as
small scanners over `unicodedata.category` that follow each pattern's
alternation order, backtracking included.
"""

from __future__ import annotations

import copy
import functools
import heapq
import json
import unicodedata
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

__all__ = ["Tokenizer", "WordPieceTokenizer", "load", "GPT2_PATTERN", "QWEN2_PATTERN",
           "LLAMA3_PATTERN", "bytes_to_unicode"]

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


def _word(c: str) -> bool:
    """Rust's `\\w`: letters, marks, decimal digits, connector punctuation
    and the joiners."""
    cat = unicodedata.category(c)
    return cat[0] in "LM" or cat in ("Nd", "Nl", "Pc") or c in "\u200c\u200d"


def _split_whitespace(text: str) -> List[str]:
    """The `Whitespace` pre-tokenizer: runs of word characters and runs of
    other non-space characters; the spaces go."""
    out, i, n = [], 0, len(text)
    while i < n:
        c = text[i]
        if c in WHITE_SPACE:
            i += 1
            continue
        word = _word(c)
        j = _run(text, i, lambda ch: ch not in WHITE_SPACE and _word(ch) == word)
        out.append(text[i:j])
        i = j
    return out


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
                      "covers byte-level BPE as Whisper's, Qwen2's and Llama-3's files use it, "
                      "and BERT's WordPiece)")


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
    if kind == "Whitespace":
        return [_split_whitespace], False
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
    if spec.get("type") == "BertProcessing":
        return [int(spec["cls"][1])], [int(spec["sep"][1])]
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


def _decoder(spec, path, byte_level: bool) -> Callable[[List[str]], str]:
    if spec is None and not byte_level:  # `tokenizers`' default: joined by spaces
        return " ".join
    if (spec or {}).get("type") != "ByteLevel" or not byte_level:
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
    """`tokenizer.json` for byte-level BPE (or the character-level BPE of a
    `Whitespace` pre-tokenizer with no decoder), with the surface the port's
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
        if not byte_level and (spec.get("pre_tokenizer") or {}).get("type") != "Whitespace":
            raise _unsupported(path, "pre-tokenizer without ByteLevel",
                               spec.get("pre_tokenizer"))
        # None: the characters are the model's symbols, with no byte mapping
        self._byte_map = bytes_to_unicode() if byte_level else None
        self._decode_tokens = _decoder(spec.get("decoder"), path, byte_level)
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

    def with_added_tokens(self, contents: Sequence[str]) -> "Tokenizer":
        """A copy with `contents` added as special tokens, as `transformers`'
        `add_special_tokens({"additional_special_tokens": ...})` adds them: a
        token the vocabulary or the added tokens already hold keeps its id, a
        new one takes the next id past the largest, in order; all are split
        out before normalizing and pre-tokenizing. The tokenizer itself is
        left as it is (`load` shares it)."""
        new = copy.copy(self)
        by_content = dict(self._added_by_content)
        nxt = max(list(self._id_to_token) + list(self._added_by_id)) + 1
        for c in contents:
            t = by_content.get(c)
            i = t.id if t is not None else self.model.vocab.get(c)
            if i is None:
                i, nxt = nxt, nxt + 1
            by_content[c] = _AddedToken({"id": i, "content": c, "special": True,
                                         "normalized": False}, self.path)
        new._added_by_content = by_content
        new._added_by_id = {t.id: t for t in by_content.values()}
        new._special = self._special | set(contents)
        new._raw = _Matcher({t.content: t for t in by_content.values() if not t.normalized})
        new._norm = _Matcher({self._normalize(t.content): t for t in by_content.values()
                              if t.normalized})
        return new

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
                    yield (w if self._byte_map is None
                           else "".join(self._byte_map[b] for b in w.encode("utf-8")))

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


# ---------------------------------------------------------------------------
# WordPiece (BERT)
# ---------------------------------------------------------------------------


def _bert_control(c: str) -> bool:
    """`BertTokenizer`'s control characters: category C*, but tab, newline
    and carriage return, which count as whitespace."""
    return c not in "\t\n\r" and unicodedata.category(c)[0] == "C"


def _bert_whitespace(c: str) -> bool:
    return c in " \t\n\r" or unicodedata.category(c) == "Zs"


def _bert_punctuation(c: str) -> bool:
    """Every non-alphanumeric ASCII character, and Unicode category P*."""
    cp = ord(c)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(c)[0] == "P"


_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def _cjk(c: str) -> bool:
    cp = ord(c)
    return any(lo <= cp <= hi for lo, hi in _CJK)


def _strip_accents(text: str) -> str:
    return "".join(c for c in unicodedata.normalize("NFD", text)
                   if unicodedata.category(c) != "Mn")


class _BertNormalizer:
    """`BertTokenizer`'s `BasicTokenizer` up to its whitespace split: drop
    NUL, U+FFFD and control characters and make every whitespace a space
    (`clean_text`), put spaces around CJK ideographs
    (`handle_chinese_chars`), compose to NFC, then lowercase and strip
    accents (`strip_accents` None follows `lowercase`)."""

    def __init__(self, clean_text: bool = True, handle_chinese_chars: bool = True,
                 strip_accents: Optional[bool] = None, lowercase: bool = False):
        self.clean_text = clean_text
        self.chinese = handle_chinese_chars
        self.strip = lowercase if strip_accents is None else strip_accents
        self.lowercase = lowercase

    @classmethod
    def from_spec(cls, spec, path) -> "_BertNormalizer":
        if (spec or {}).get("type") != "BertNormalizer":
            raise _unsupported(path, "normalizer", spec)
        return cls(bool(spec.get("clean_text", True)),
                   bool(spec.get("handle_chinese_chars", True)),
                   spec.get("strip_accents"), bool(spec.get("lowercase", True)))

    def __call__(self, text: str) -> str:
        if self.clean_text:
            text = "".join(" " if _bert_whitespace(c) else c for c in text
                           if c not in "\x00\ufffd" and not _bert_control(c))
        if self.chinese:
            text = "".join(f" {c} " if _cjk(c) else c for c in text)
        text = unicodedata.normalize("NFC", text)
        if self.lowercase:
            text = text.lower()
        return _strip_accents(text) if self.strip else text


def _bert_words(text: str) -> List[str]:
    """`BertPreTokenizer`: split at whitespace, then every punctuation
    character a word of its own."""
    out: List[str] = []
    for word in text.split():
        start = 0
        for i, c in enumerate(word):
            if _bert_punctuation(c):
                if start < i:
                    out.append(word[start:i])
                out.append(c)
                start = i + 1
        if start < len(word):
            out.append(word[start:])
    return out


class _WordPiece:
    """Greedy longest match from the word's start, the continuation pieces
    prefixed (`##`); a word with a piece outside the vocabulary, or longer
    than `max_input_chars_per_word` characters, is the unknown token."""

    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]", prefix: str = "##",
                 max_input_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.prefix = prefix
        self.max_chars = max_input_chars_per_word

    @classmethod
    def from_spec(cls, spec, path) -> "_WordPiece":
        if spec.get("type") != "WordPiece":
            raise _unsupported(path, "model", {"type": spec.get("type")})
        return cls(dict(spec["vocab"]), spec.get("unk_token", "[UNK]"),
                   spec.get("continuing_subword_prefix", "##"),
                   int(spec.get("max_input_chars_per_word", 100)))

    def tokenize(self, word: str) -> List[str]:
        if len(word) > self.max_chars:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            while end > start:
                piece = word[start:end] if start == 0 else self.prefix + word[start:end]
                if piece in self.vocab:
                    break
                end -= 1
            if end == start:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces


# the special tokens `BertTokenizer` takes by default, split out of the text
# before it is normalized
BERT_SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


class WordPieceTokenizer:
    """BERT's WordPiece with the surface the port's callers use (`encode`,
    `decode`, `token_to_id`, `id_to_token`, `get_vocab_size`), held to
    `transformers.BertTokenizer`. Added tokens (the special ones among them)
    are split out of the raw text first, leftmost and longest; `encode`
    with `add_special_tokens` wraps the ids as `[CLS] … [SEP]`, as the
    post-processor says."""

    def __init__(self, model: _WordPiece, normalizer: _BertNormalizer,
                 added: Sequence[_AddedToken], before: Sequence[int] = (),
                 after: Sequence[int] = (), cleanup: bool = True,
                 path: Union[str, Path] = "tokenizer.json"):
        self.path = str(path)
        self.model = model
        self._normalize = normalizer
        self._added_by_id = {t.id: t for t in added}
        self._added_by_content = {t.content: t for t in added}
        self._special = {t.content for t in added if t.special}
        self._raw = _Matcher({t.content: t for t in added if not t.normalized})
        self._norm = _Matcher({normalizer(t.content): t for t in added if t.normalized})
        self._id_to_token = {i: t for t, i in model.vocab.items()}
        self._before, self._after = list(before), list(after)
        self._cleanup = cleanup
        self._unk_id = model.vocab.get(model.unk_token)

    @classmethod
    def from_spec(cls, spec: dict, path: Union[str, Path] = "tokenizer.json"
                  ) -> "WordPieceTokenizer":
        for key in ("truncation", "padding"):
            if spec.get(key) is not None:
                raise _unsupported(path, key, spec[key])
        model = _WordPiece.from_spec(spec.get("model", {}), path)
        normalizer = _BertNormalizer.from_spec(spec.get("normalizer"), path)
        if (spec.get("pre_tokenizer") or {}).get("type") != "BertPreTokenizer":
            raise _unsupported(path, "pre-tokenizer", spec.get("pre_tokenizer"))
        decoder = spec.get("decoder") or {}
        if decoder.get("type") != "WordPiece" or decoder.get("prefix", "##") != model.prefix:
            raise _unsupported(path, "decoder", spec.get("decoder"))
        added = [_AddedToken(t, path) for t in spec.get("added_tokens", [])]
        for t in added:
            if model.vocab.get(t.content, t.id) != t.id:
                raise ValueError(f"{path}: added token {t.content!r} has id {t.id}, the "
                                 f"vocabulary {model.vocab[t.content]}")
        token_to_id = {**model.vocab, **{t.content: t.id for t in added}}

        def require(token: str) -> int:
            if token not in token_to_id:
                raise ValueError(f"{path}: the template names {token!r}, which has no id")
            return token_to_id[token]

        before, after = _post_processor(spec.get("post_processor"), path, require)
        return cls(model, normalizer, added, before, after,
                   bool(decoder.get("cleanup", True)), path)

    @classmethod
    def from_vocab_txt(cls, path: Union[str, Path]) -> "WordPieceTokenizer":
        """A bare `vocab.txt` (one token a line, its line number its id) as
        `BertTokenizer(vocab_file, do_lower_case=False)` reads it:
        `bert-base-multilingual-cased`'s settings (cased, accents kept, CJK
        split)."""
        path = Path(path)
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        added = [_AddedToken({"content": t, "id": vocab[t], "special": True}, path)
                 for t in BERT_SPECIAL_TOKENS if t in vocab]
        for t in BERT_SPECIAL_TOKENS[1:4]:
            if t not in vocab:
                raise ValueError(f"{path}: the vocabulary has no {t}")
        return cls(_WordPiece(vocab), _BertNormalizer(), added, [vocab["[CLS]"]],
                   [vocab["[SEP]"]], True, path)

    # ---- vocabulary ----

    def token_to_id(self, token: str) -> Optional[int]:
        t = self._added_by_content.get(token)
        return t.id if t is not None else self.model.vocab.get(token)

    def id_to_token(self, i: int) -> Optional[str]:
        t = self._added_by_id.get(int(i))
        return t.content if t is not None else self._id_to_token.get(int(i))

    def get_vocab_size(self, with_added_tokens: bool = True) -> int:
        ids = set(self._id_to_token)
        if with_added_tokens:
            ids |= set(self._added_by_id)
        return len(ids)

    # ---- encode / decode ----

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids: List[int] = list(self._before) if add_special_tokens else []
        for raw, tok in self._raw.split(text):
            if tok is not None:
                ids.append(tok.id)
                continue
            for piece, ntok in self._norm.split(self._normalize(raw)):
                if ntok is not None:
                    ids.append(ntok.id)
                    continue
                for word in _bert_words(piece):
                    ids.extend(self.model.vocab.get(p, self._unk_id)
                               for p in self.model.tokenize(word))
        if add_special_tokens:
            ids.extend(self._after)
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        """`BertTokenizer.decode`: pieces joined by spaces with the `##`
        continuations glued on, an added token that is not special a piece
        of its own, then the tokenization spaces cleaned up."""
        texts: List[str] = []
        run: List[str] = []

        def flush():
            if run:
                s = " ".join(run).replace(" " + self.model.prefix, "").strip()
                if s:
                    texts.append(s)
                run.clear()

        for i in ids:
            t = self.id_to_token(int(i))
            if t is None:
                t = self.model.unk_token
            if t in self._special:
                if skip_special_tokens:
                    continue
                run.append(t)
            elif t in self._added_by_content:
                flush()
                texts.append(t)
            else:
                run.append(t)
        flush()
        text = " ".join(texts)
        if self._cleanup:
            for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                         (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"),
                         (" 're", "'re")):
                text = text.replace(a, b)
        return text


@functools.lru_cache(maxsize=8)
def _load(path: str, mtime_ns: int, size: int) -> Union[Tokenizer, WordPieceTokenizer]:
    if Path(path).suffix == ".txt":
        return WordPieceTokenizer.from_vocab_txt(path)
    spec = json.loads(Path(path).read_text(encoding="utf-8"))
    if (spec.get("model") or {}).get("type") == "WordPiece":
        return WordPieceTokenizer.from_spec(spec, path)
    return Tokenizer(spec, path)


def load(path: Union[str, Path]) -> Union[Tokenizer, WordPieceTokenizer]:
    """A `tokenizer.json` (byte-level BPE or WordPiece) or a WordPiece
    `vocab.txt` (read with `bert-base-multilingual-cased`'s settings), parsed
    once per file version: a server builds a tokenizer per request, and a
    150k-token vocabulary takes a while to parse in Python. A directory
    gives its `tokenizer.json`."""
    p = Path(path)
    if p.is_dir():
        p = p / "tokenizer.json"
    st = p.stat()
    return _load(str(p.resolve()), st.st_mtime_ns, st.st_size)


def config_token_id(directory: Union[str, Path], tok, name: str) -> Optional[int]:
    """The id of the special token `name` ("bos_token", "eos_token",
    "pad_token") that the directory's `tokenizer_config.json` names (a
    string or an AddedToken dict), as `transformers` gives it as
    `<name>_id`; None where the file, the entry or its id is absent."""
    path = Path(directory) / "tokenizer_config.json"
    if not path.is_file():
        return None
    entry = json.loads(path.read_text(encoding="utf-8")).get(name)
    if isinstance(entry, dict):
        entry = entry.get("content")
    return tok.token_to_id(entry) if entry else None
