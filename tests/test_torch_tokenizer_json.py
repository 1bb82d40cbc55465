"""The port's `tokenizer.json` reader against the `tokenizers` library (and
`transformers.AutoTokenizer` for the Qwen2 file): identical `encode` ids and
`decode` strings on a fixed corpus and on arbitrary Unicode text
(hypothesis), for a Whisper-style, a Qwen2-style and a Llama-3-style
(digits split in threes, <|begin_of_text|> added by a `Sequence`
post-processor) byte-level BPE trained here with `tokenizers`, and for the
files `chip_smoke.py` writes into its checkpoint directories. Components the
reader does not cover raise."""

import importlib.util
import json
from pathlib import Path

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from tokenizers import AddedToken, Regex, decoders, models, normalizers, pre_tokenizers
from tokenizers import Tokenizer as HFTokenizer
from tokenizers import processors, trainers

from mlx_audio_tpu_torch.tokenizer_json import LLAMA3_PATTERN, QWEN2_PATTERN, Tokenizer

REPO = Path(__file__).resolve().parent.parent

CORPUS = [
    "Hello world! It's a test of the tokenizer; it'll do.",
    "The quick brown fox jumps over the lazy dog while the synthesis model turns text into "
    "speech.",
    "Multiple   spaces,\ttabs\t\tand\nnewlines\n\n\nand\r\nCRLF\r\n line ends  \n",
    "Digits 0 12 345 6789 3.14159 1,000,000 and ²³ ½ Ⅻ ٣٤",
    "Ünïcödé: Straße, façade, naïve, coöperate, é (decomposed), Å",
    "Scripts: 你好世界 こんにちは 안녕하세요 Привет мир مرحبا שלום नमस्ते ไทย",
    "Case: 'S 'T 'RE 'VE 'M 'LL 'D and 's 't 're 've 'm 'll 'd and 'ſ",
    "Emoji 😀👍🏽 and symbols ♪♫ ~!@#$%^&*()_+-=[]{}|;:,.<>/?",
    "<|startoftranscript|><|en|><|transcribe|> text<|0.00|> more <|endoftext|>",
    "<|im_start|>assistant\nHello there<|im_end|>\n<|im_start|>user\n hi <|im_end|>",
    "specials inside<|endoftext|>words and <mask>  after [R]   x éx",
    "", " ", "   ", "\n", "a", " a", "  a", "a  ", "　 z y x\x1cw\x85v",
]

WHISPER_SPECIALS = ["<|endoftext|>", "<|startoftranscript|>", "<|en|>", "<|es|>",
                    "<|translate|>", "<|transcribe|>", "<|startofprev|>", "<|nospeech|>",
                    "<|notimestamps|>"]
QWEN_SPECIALS = ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
LLAMA3_SPECIALS = ["<|begin_of_text|>", "<|end_of_text|>", "<|eot_id|>"]
TRAIN_TEXT = [t for t in CORPUS if "<|" not in t] * 20 + [
    "the assistant said hello to the user in the world of speech synthesis"] * 50


def _train(style: str) -> HFTokenizer:
    tok = HFTokenizer(models.BPE())
    if style == "whisper":
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
        specials = WHISPER_SPECIALS
    else:
        if style == "qwen2":
            tok.normalizer = normalizers.NFC()
        tok.pre_tokenizer = pre_tokenizers.Sequence([
            pre_tokenizers.Split(Regex(QWEN2_PATTERN if style == "qwen2" else LLAMA3_PATTERN),
                                 behavior="isolated"),
            pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
        specials = QWEN_SPECIALS if style == "qwen2" else LLAMA3_SPECIALS
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.ByteLevel(trim_offsets=False)
    trainer = trainers.BpeTrainer(vocab_size=600, special_tokens=specials,
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
                                  show_progress=False)
    tok.train_from_iterator(TRAIN_TEXT, trainer)
    if style == "whisper":  # timestamps: added, not special
        tok.add_tokens([AddedToken(f"<|{i * 0.02:.2f}|>", normalized=False, special=False)
                        for i in range(4)])
    if style == "llama3":  # Llama-3's post-processor: ByteLevel, then the template
        bos = tok.token_to_id("<|begin_of_text|>")
        tok.post_processor = processors.Sequence([
            processors.ByteLevel(trim_offsets=False),
            processors.TemplateProcessing(single="<|begin_of_text|> $A",
                                          pair="<|begin_of_text|> $A <|begin_of_text|> $B",
                                          special_tokens=[("<|begin_of_text|>", bos)])])
    # the added-token options the reader covers
    tok.add_tokens([AddedToken("<mask>", lstrip=True, normalized=False),
                    AddedToken("[R]", rstrip=True, normalized=False),
                    AddedToken("éx", normalized=True)])
    return tok


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write(tok: HFTokenizer, path: Path, edit=None) -> Path:
    spec = json.loads(tok.to_str())
    if edit is not None:
        edit(spec)
    path.write_text(json.dumps(spec, ensure_ascii=False), encoding="utf-8")
    return path


def _string_merges(spec):
    spec["model"]["merges"] = [" ".join(m) for m in spec["model"]["merges"]]


def _ignore_merges(spec):
    spec["model"]["ignore_merges"] = True


def _template(spec):
    ids = {t["content"]: t["id"] for t in spec["added_tokens"]}
    spec["post_processor"] = {
        "type": "TemplateProcessing",
        "single": [{"SpecialToken": {"id": "<|startoftranscript|>", "type_id": 0}},
                   {"SpecialToken": {"id": "<|notimestamps|>", "type_id": 0}},
                   {"Sequence": {"id": "A", "type_id": 0}},
                   {"SpecialToken": {"id": "<|endoftext|>", "type_id": 0}}],
        "pair": [{"Sequence": {"id": "A", "type_id": 0}}, {"Sequence": {"id": "B", "type_id": 1}}],
        "special_tokens": {n: {"id": n, "ids": [ids[n]], "tokens": [n]}
                           for n in ("<|startoftranscript|>", "<|notimestamps|>",
                                     "<|endoftext|>")}}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tok")
    whisper, qwen, llama3 = _train("whisper"), _train("qwen2"), _train("llama3")
    cs = _chip_smoke()
    out = {
        "whisper": _write(whisper, d / "whisper.json", _string_merges),
        "whisper_template": _write(whisper, d / "whisper_template.json", _template),
        "qwen2": _write(qwen, d / "qwen2.json"),
        "qwen2_ignore_merges": _write(qwen, d / "qwen2_ignore.json", _ignore_merges),
        "chip_whisper": cs.write_tokenizer_json(d / "chip_whisper.json", "whisper"),
        "chip_qwen2": cs.write_tokenizer_json(d / "chip_qwen2.json", "qwen2"),
        "llama3": _write(llama3, d / "llama3.json"),
        "chip_llama3": cs.write_tokenizer_json(d / "chip_llama3.json", "llama3"),
    }
    return {k: (HFTokenizer.from_file(str(p)), Tokenizer.from_file(p), p)
            for k, p in out.items()}


NAMES = ["whisper", "whisper_template", "qwen2", "qwen2_ignore_merges", "chip_whisper",
         "chip_qwen2", "llama3", "chip_llama3"]


def _same(hf, me, text):
    for special in (False, True):
        want = hf.encode(text, add_special_tokens=special).ids
        got = me.encode(text, add_special_tokens=special)
        assert got == want, (text, special)
    for skip in (True, False):
        assert me.decode(want, skip_special_tokens=skip) == hf.decode(
            want, skip_special_tokens=skip), (text, skip)


@pytest.mark.parametrize("name", NAMES)
def test_corpus_matches_tokenizers(files, name):
    hf, me, _ = files[name]
    for text in CORPUS:
        _same(hf, me, text)


@pytest.mark.parametrize("name", NAMES)
def test_vocabulary_lookups_match(files, name):
    hf, me, _ = files[name]
    assert me.get_vocab_size() == hf.get_vocab_size()
    for i in range(hf.get_vocab_size() + 3):
        tok = hf.id_to_token(i)
        assert me.id_to_token(i) == tok
        if tok is not None:
            assert me.token_to_id(tok) == hf.token_to_id(tok)
    assert me.token_to_id("not a token at all") is None


PROPERTY = settings(max_examples=150, deadline=None, derandomize=True, database=None,
                    suppress_health_check=[HealthCheck.function_scoped_fixture])


@pytest.mark.parametrize("name", ["whisper", "qwen2", "chip_qwen2"])
@PROPERTY
@given(text=st.text(max_size=48))
def test_arbitrary_unicode_matches_tokenizers(files, name, text):
    hf, me, _ = files[name]
    _same(hf, me, text)


@pytest.mark.parametrize("name", ["whisper", "qwen2"])
@PROPERTY
@given(parts=st.lists(st.one_of(
    st.text(alphabet=st.characters(codec="utf-8"), max_size=12),
    st.sampled_from(["<|endoftext|>", "<|im_start|>", "<|im_end|>", "<|en|>", "<mask>",
                     "[R]", "éx", " ", "  ", "\n", "\r\n", "'s", "'LL", "ſ"])),
    max_size=8))
def test_special_tokens_inside_text_match(files, name, parts):
    hf, me, _ = files[name]
    _same(hf, me, "".join(parts))


@pytest.mark.parametrize("name", ["whisper", "qwen2"])
@PROPERTY
@given(data=st.data())
def test_decode_of_arbitrary_ids_matches(files, name, data):
    hf, me, _ = files[name]
    ids = data.draw(st.lists(st.integers(0, hf.get_vocab_size() + 2), max_size=24))
    for skip in (True, False):
        assert me.decode(ids, skip_special_tokens=skip) == hf.decode(
            ids, skip_special_tokens=skip)


@pytest.mark.parametrize("name", ["qwen2", "chip_qwen2"])
def test_qwen2_file_matches_autotokenizer(files, name, tmp_path):
    """Qwen3-TTS's calls: `AutoTokenizer.from_pretrained(dir).encode(text)`."""
    from transformers import AutoTokenizer

    _, me, path = files[name]
    (tmp_path / "tokenizer.json").write_bytes(Path(path).read_bytes())
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "Qwen2TokenizerFast", "clean_up_tokenization_spaces": False,
        "eos_token": "<|im_end|>", "pad_token": "<|endoftext|>", "unk_token": None,
        "bos_token": None}))
    auto = AutoTokenizer.from_pretrained(str(tmp_path))
    for text in CORPUS + ["<|im_start|>assistant\nThe quick brown fox.<|im_end|>\n"
                          "<|im_start|>assistant\n"]:
        assert me.encode(text) == auto.encode(text), text


def test_chip_smoke_files_fit_the_models(files):
    """The generated files put the added tokens at the ids the models read:
    Whisper-large-v3's layout up to n_vocab = 51866, and Qwen3-TTS's chat
    prefix as three tokens (the model slices the prompt by position)."""
    _, w, _ = files["chip_whisper"]
    assert w.token_to_id("<|endoftext|>") == 50257
    assert w.token_to_id("<|startoftranscript|>") == 50258
    assert w.token_to_id("<|notimestamps|>") == 50364
    assert w.token_to_id("<|0.00|>") == 50365
    assert w.token_to_id("<|30.00|>") == 51865
    _, q, _ = files["chip_qwen2"]
    assert q.encode("<|im_start|>assistant\n") == [151644, q.token_to_id("assistant"),
                                                   q.token_to_id("Ċ")]
    assert q.token_to_id("<|im_end|>") == 151645
    assert q.get_vocab_size() == 151674
    assert [q.token_to_id(t) for t in ("<tts_pad>", "<tts_text_bos>", "<tts_text_eod>")] == [
        151671, 151672, 151673]


def test_chip_smoke_llama3_file_fits_orpheus(files):
    """The generated Llama-3 file: <|begin_of_text|> (128000) first in every
    encode, <|eot_id|> at 128009 (Orpheus's END_OF_TEXT), 128256 ids, and
    digits in runs of three."""
    hf, me, _ = files["chip_llama3"]
    assert me.token_to_id("<|begin_of_text|>") == 128000
    assert me.token_to_id("<|eot_id|>") == 128009
    assert me.get_vocab_size() == 128256
    ids = me.encode("tara: 12345")
    assert ids[0] == 128000 and ids == hf.encode("tara: 12345").ids
    text = "tara: 12345 and ٣٤٥٦٧, 7"
    want = [p for p, _ in hf.pre_tokenizer.pre_tokenize_str(text)]
    assert list(me._pieces(text)) == want
    assert [p for p in want if p.isdigit()] == ["123", "45", "7"]


def _spec(tok: HFTokenizer) -> dict:
    return json.loads(tok.to_str())


@pytest.mark.parametrize("edit, what", [
    (lambda s: s.update(model={"type": "WordPiece", "vocab": {"a": 0}, "unk_token": "a",
                               "continuing_subword_prefix": "##",
                               "max_input_chars_per_word": 100}), "model"),
    (lambda s: s.update(normalizer={"type": "NFKC"}), "normalizer"),
    (lambda s: s.update(pre_tokenizer={"type": "Metaspace", "replacement": "▁",
                                       "prepend_scheme": "always", "split": True}),
     "pre-tokenizer"),
    (lambda s: s["pre_tokenizer"]["pretokenizers"][0]["pattern"].update(Regex=r"\w+"),
     "Split pre-tokenizer"),
    (lambda s: s.update(decoder={"type": "WordPiece", "prefix": "##", "cleanup": True}),
     "decoder"),
    (lambda s: s.update(post_processor={"type": "RobertaProcessing", "sep": ["</s>", 2],
                                        "cls": ["<s>", 0]}), "post-processor"),
    (lambda s: s["added_tokens"][0].update(single_word=True), "single_word"),
    (lambda s: s["model"].update(byte_fallback=True), "byte_fallback"),
    (lambda s: s.update(truncation={"max_length": 8}), "truncation"),
], ids=["wordpiece", "nfkc", "metaspace", "other_split", "wordpiece_decoder", "roberta",
        "single_word", "byte_fallback", "truncation"])
def test_unsupported_components_raise(tmp_path, edit, what):
    spec = _spec(_train("qwen2"))
    edit(spec)
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(spec), encoding="utf-8")
    with pytest.raises(ValueError, match=f"unsupported.*{what}"):
        Tokenizer.from_file(path)


def test_added_ids_that_tokenizers_would_move_raise(tmp_path):
    """`tokenizers` numbers added tokens outside the vocabulary on from the
    largest id so far, whatever the file says; a file with a gap would read
    differently there, so the reader refuses it."""
    spec = _spec(_train("qwen2"))
    spec["added_tokens"][-1]["id"] += 5
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(spec), encoding="utf-8")
    with pytest.raises(ValueError, match="would give it"):
        Tokenizer.from_file(path)
