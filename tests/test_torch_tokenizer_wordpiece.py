"""The port's WordPiece reader (Bark's text tokenizer, `bert-base-multilingual-
cased`) against `transformers.BertTokenizer`, which the JAX package's Bark
calls, and against the `tokenizers` library's `BertWordPieceTokenizer`, on
a vocabulary written here: identical `encode` ids, with and without the
special tokens, and identical `decode` strings, read from a `tokenizer.json`
and from a bare `vocab.txt`, cased (Bark's) and lowercased. The corpus
covers accents, CJK, punctuation runs, control characters, an unknown word
and a word over `max_input_chars_per_word`; a hypothesis run holds the
reader to `BertTokenizer` on arbitrary text. `BertTokenizer` composes the
text to NFC and `tokenizers` does not, so a decomposed accent is held to
`BertTokenizer` only."""

import json
import unicodedata

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from tokenizers import BertWordPieceTokenizer
from transformers import BertTokenizer

from mlx_audio_tpu_torch.tokenizer_json import WordPieceTokenizer, load

SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
CORPUS = [
    "Hello world! It's a test of the tokenizer; it'll do.",
    "Café, naïve résumé: Straße, façade, coöperate, Åland, ÉCOLE",
    "Scripts: 你好世界 こんにちは 안녕하세요 Привет мир مرحبا שלום नमस्ते ไทย",
    "Wait...!!?  (yes)--[no]; {maybe} 'quoted' \"double\" «guillemets» ¿qué? ¡sí!",
    "Tabs\tand\nnewlines\r\nand\x00nul\x07bell\u200bzero-width\ufffdreplacement\x85nel",
    "An unknown word: ☃snowman☃ and ☃ alone",
    "Long " + "a" * 101 + " word and " + "b" * 100 + " at the limit",
    "Digits 0 12 345 3.14159 1,000,000 ²³ ½",
    "specials inside[MASK]words and [CLS] [SEP] [UNK]x [PAD]",
    "Mixed 漢字and latin字母 together",
    "line\u2028separator\u2029paragraph\u3000ideographic space",
    "", " ", "   ", "\n", "a", " a", "a  ",
]
# a decomposed accent: BertTokenizer composes it to NFC, tokenizers does not
NFC_ONLY = ["Cafe\u0301 and nai\u0308ve", "e\u0301"]
UNKNOWN = "☃"
WORDS = ["Hello", "world", "test", "token", "##izer", "##s", "the", "it", "Caf", "##é",
         "naïve", "rés", "##umé", "Stra", "##ße", "façade", "École", "ÉCOLE", "你", "好",
         "Привет", "мир", "Wait", "yes", "no", "maybe", "quoted", "double", "Digits", "3",
         "##14", "##159", "000", "special", "##s", "inside", "words", "Mixed", "latin",
         "together", "line", "##separator", "paragraph", "hello", "école", "cafe", "naive"]


def _vocab():
    chars = set()
    for text in CORPUS + NFC_ONLY:
        for form in ("NFC", "NFD"):
            t = unicodedata.normalize(form, text)
            chars |= set(t) | set(t.lower())
    chars = sorted(c for c in chars if not c.isspace() and c != UNKNOWN
                   and unicodedata.category(c)[0] != "C")
    toks = SPECIALS + chars + ["##" + c for c in chars] + WORDS
    seen, out = set(), []
    for t in toks:
        if t not in seen:
            seen.add(t)
            out.append(t)
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("wordpiece")
    vocab = _vocab()
    (d / "vocab.txt").write_text("\n".join(vocab) + "\n", encoding="utf-8")
    out = {}
    for lower in (False, True):
        hf = BertWordPieceTokenizer(str(d / "vocab.txt"), lowercase=lower)
        path = d / f"tokenizer_{'lower' if lower else 'cased'}.json"
        hf.save(str(path))
        out[lower] = (hf, path, BertTokenizer(str(d / "vocab.txt"), do_lower_case=lower))
    return d, out


@pytest.mark.parametrize("lower,source", [(False, "tokenizer.json"), (True, "tokenizer.json"),
                                          (False, "vocab.txt")],
                         ids=["cased-tokenizer.json", "lowercase-tokenizer.json",
                              "cased-vocab.txt"])
def test_encode_matches_bert_tokenizer_and_tokenizers(files, lower, source):
    """A vocab.txt reads with bert-base-multilingual-cased's settings (cased);
    a tokenizer.json with its normalizer's."""
    d, out = files
    hf, path, slow = out[lower]
    port = load(path) if source == "tokenizer.json" else load(d / "vocab.txt")
    assert isinstance(port, WordPieceTokenizer)
    for text in CORPUS + NFC_ONLY:
        for special in (False, True):
            want = slow.encode(text, add_special_tokens=special)
            assert port.encode(text, add_special_tokens=special) == want, (text, special)
            if text not in NFC_ONLY:
                assert hf.encode(text, add_special_tokens=special).ids == want, (text, special)
    unk = slow.convert_tokens_to_ids("[UNK]")
    assert port.encode("☃snowman☃", add_special_tokens=False) == [unk]
    assert port.encode("a" * 101, add_special_tokens=False) == [unk]
    assert unk not in port.encode("a" * 100, add_special_tokens=False)


def test_decode_matches_bert_tokenizer(files):
    d, out = files
    _, path, slow = out[False]
    port = load(path)
    for text in CORPUS:
        ids = slow.encode(text)
        for skip in (False, True):
            assert port.decode(ids, skip_special_tokens=skip) == slow.decode(
                ids, skip_special_tokens=skip), (text, skip)


def test_vocabulary_surface(files):
    d, out = files
    _, path, slow = out[False]
    port = load(d / "vocab.txt")
    assert port.get_vocab_size() == slow.vocab_size == len(_vocab())
    for tok in ("[CLS]", "##izer", "你", "Hello"):
        i = slow.convert_tokens_to_ids(tok)
        assert port.token_to_id(tok) == i and port.id_to_token(i) == tok


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.text(max_size=40))
def test_arbitrary_text_matches_bert_tokenizer(files, text):
    _, out = files
    _, path, slow = out[False]
    assert load(path).encode(text, add_special_tokens=False) == slow.encode(
        text, add_special_tokens=False)


def test_unsupported_components_raise(files, tmp_path):
    _, out = files
    spec = json.loads(out[False][1].read_text(encoding="utf-8"))
    for key, bad in (("pre_tokenizer", {"type": "Whitespace"}),
                     ("normalizer", {"type": "NFKC"}),
                     ("decoder", {"type": "ByteLevel"})):
        broken = dict(spec, **{key: bad})
        p = tmp_path / f"{key}.json"
        p.write_text(json.dumps(broken), encoding="utf-8")
        with pytest.raises(ValueError, match="unsupported"):
            load(p)
