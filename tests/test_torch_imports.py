"""The port imports neither jax nor anything of the JAX package, at run
time (every module imported in a fresh interpreter) or in its source (a
static scan of every import, chip_smoke.py included), the serving modules
among them. Nor does it import,
at module level, a package the card's machine lacks (safetensors,
tokenizers, transformers, ml_dtypes, huggingface_hub): only a function may
import one, and raise where it is absent. The loader reads and writes
checkpoints with those packages blocked."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "mlx_audio_tpu_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield path, ".".join(parts)


def test_import_every_module_without_jax():
    names = [name for _, name in _modules()]
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'mlx_audio_tpu'))\n"
        "assert not bad, bad\n"
        "print('OK', len(" + repr(names) + "))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")


def _absolute_imports(path: Path, module: str):
    tree = ast.parse(path.read_text())
    pkg_parts = module.split(".") if path.name == "__init__.py" else module.split(".")[:-1]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg_parts[: len(pkg_parts) - node.level + 1]
                yield node.lineno, ".".join(base + ([node.module] if node.module else []))
            else:
                yield node.lineno, node.module


def test_static_scan_of_imports():
    files = list(_modules()) + [(REPO / "chip_smoke.py", "chip_smoke")]
    bad = []
    for path, module in files:
        for line, name in _absolute_imports(path, module):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "mlx_audio_tpu"):
                bad.append(f"{path.relative_to(REPO)}:{line}: {name}")
    assert not bad, bad


# installed here, absent on the card's machine
NOT_ON_THE_CARD = ("safetensors", "tokenizers", "transformers", "ml_dtypes", "huggingface_hub")


def _module_level_imports(path: Path, module: str):
    """The absolute imports outside any function body (a class body counts
    as module level: it runs at import)."""
    tree = ast.parse(path.read_text())
    pkg_parts = module.split(".") if path.name == "__init__.py" else module.split(".")[:-1]
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg_parts[: len(pkg_parts) - node.level + 1]
                yield node.lineno, ".".join(base + ([node.module] if node.module else []))
            else:
                yield node.lineno, node.module
        stack.extend(ast.iter_child_nodes(node))


def test_static_scan_of_module_level_imports():
    files = list(_modules()) + [(REPO / "chip_smoke.py", "chip_smoke")]
    bad = []
    for path, module in files:
        for line, name in _module_level_imports(path, module):
            if name.split(".")[0] in NOT_ON_THE_CARD:
                bad.append(f"{path.relative_to(REPO)}:{line}: {name}")
    assert not bad, bad


def test_module_level_scan_sees_what_it_must():
    """The scan flags a top-level and a class-level import of a blocked
    package, and passes one inside a function."""
    import tempfile

    src = ("import numpy\nfrom safetensors.numpy import load_file\n"
           "class A:\n    import tokenizers\n"
           "def f():\n    import transformers\n")
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "m.py"
        path.write_text(src)
        names = [n for _, n in _module_level_imports(path, "pkg.m")]
    assert sorted(n for n in names if n.split(".")[0] in NOT_ON_THE_CARD) == [
        "safetensors.numpy", "tokenizers"]


def test_loader_without_the_missing_packages(tmp_path):
    """With safetensors, tokenizers, transformers, ml_dtypes and
    huggingface_hub made unimportable, the port writes a bf16 and a uint32
    checkpoint, reads it back bit for bit, and loads a Kokoro voice pack."""
    code = (
        "import sys\n"
        f"for n in {NOT_ON_THE_CARD!r}:\n"
        "    sys.modules[n] = None\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import numpy as np, torch\n"
        "from mlx_audio_tpu_torch import convert, utils\n"
        "from mlx_audio_tpu_torch.tts.models.kokoro.pipeline import load_voice_tensor\n"
        "from mlx_audio_tpu_torch.safetensors_io import save_file\n"
        f"d = {str(tmp_path)!r}\n"
        "w = {'a.weight': torch.randn(3, 4).bfloat16(),\n"
        "     'b.weight': np.arange(6, dtype=np.uint32).reshape(2, 3)}\n"
        "convert.save_model(__import__('pathlib').Path(d), w, {'model_type': 'x'})\n"
        "got = utils.load_weight_files(d)\n"
        "assert torch.equal(got['a.weight'], w['a.weight'])\n"
        "assert got['b.weight'].dtype == np.uint32\n"
        "assert np.array_equal(got['b.weight'], w['b.weight'])\n"
        "save_file({'voice': np.ones((4, 1, 8), np.float32)}, d + '/v.safetensors')\n"
        "assert load_voice_tensor(d + '/v.safetensors').shape == (4, 1, 8)\n"
        "print('OK')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "OK"


TINY_BIGVGAN = dict(num_mels=8, upsample_rates=[2], upsample_kernel_sizes=[4],
                    upsample_initial_channel=8, resblock_kernel_sizes=[3],
                    resblock_dilation_sizes=[[1]], gpt_dim=16, speaker_embedding_dim=4)


def _tiny_entry_points():
    from mlx_audio_tpu_torch.sts.models.mossformer2_se import Model as MossFormer2SE
    from mlx_audio_tpu_torch.stt.models.whisper import Model as Whisper
    from mlx_audio_tpu_torch.tts.models.kokoro import Model as Kokoro
    from mlx_audio_tpu_torch.tts.models.llama import Model as Orpheus
    from mlx_audio_tpu_torch.tts.models.qwen3 import Model as Vyvo
    from mlx_audio_tpu_torch.tts.models.qwen3_tts import Model as Qwen3TTS
    from mlx_audio_tpu_torch.tts.models.dia import Model as Dia
    from mlx_audio_tpu_torch.tts.models.outetts import Model as OuteTTS
    from mlx_audio_tpu_torch.tts.models.sesame import Model as Sesame
    from mlx_audio_tpu_torch.tts.models.bark import Model as Bark
    from mlx_audio_tpu_torch.stt.models.wav2vec import Model as Wav2Vec2
    from mlx_audio_tpu_torch.tts.models.soprano import Model as Soprano
    from mlx_audio_tpu_torch.tts.models.spark import Model as Spark
    from mlx_audio_tpu_torch.tts.models.indextts import Model as IndexTTS

    whisper = dict(n_mels=80, n_audio_ctx=8, n_audio_state=16, n_audio_head=2,
                   n_audio_layer=1, n_vocab=64, n_text_ctx=8, n_text_state=16,
                   n_text_head=2, n_text_layer=1)
    qwen3 = dict(talker_config=dict(
        hidden_size=16, intermediate_size=32, num_hidden_layers=1, num_attention_heads=2,
        num_key_value_heads=1, head_dim=8, text_hidden_size=16, text_vocab_size=8,
        vocab_size=16, num_code_groups=2, code_predictor_config=dict(
            hidden_size=16, intermediate_size=32, num_hidden_layers=1, num_attention_heads=2,
            num_key_value_heads=1, head_dim=8, vocab_size=16, num_code_groups=2)),
        tokenizer_config=dict(decoder_config=dict(
            latent_dim=16, codebook_dim=8, codebook_size=16, decoder_dim=16, hidden_size=16,
            intermediate_size=32, head_dim=8, num_attention_heads=2, num_key_value_heads=2,
            num_hidden_layers=1, num_quantizers=2, upsample_rates=[2], upsampling_ratios=[2])))
    mossformer2_se = dict(in_channels=12, out_channels=16, num_blocks=1, num_mels=4)
    kokoro = dict(istftnet=dict(
        resblock_kernel_sizes=[3], upsample_rates=[2], upsample_initial_channel=8,
        resblock_dilation_sizes=[[1]], upsample_kernel_sizes=[4], gen_istft_n_fft=4,
        gen_istft_hop_size=1), dim_in=8, hidden_dim=8, style_dim=4, n_layer=1, max_dur=4,
        plbert=dict(hidden_size=8, num_attention_heads=2, intermediate_size=8,
                    max_position_embeddings=16, num_hidden_layers=1, embedding_size=8))
    lm = dict(hidden_size=16, num_hidden_layers=1, intermediate_size=32,
              num_attention_heads=2, num_key_value_heads=1, vocab_size=32)
    sesame = dict(text_vocab_size=16, audio_vocab_size=8, audio_num_codebooks=2,
                  hidden_size=16, intermediate_size=32, num_hidden_layers=1,
                  num_attention_heads=2, num_key_value_heads=1, head_dim=8,
                  depth_decoder_config=dict(
                      backbone_hidden_size=16, hidden_size=16, intermediate_size=32,
                      num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
                      head_dim=8, num_codebooks=2, vocab_size=8))
    dia = {"model": {"encoder": {"n_layer": 1, "n_embd": 16, "n_hidden": 32, "n_head": 2,
                                 "head_dim": 8},
                     "decoder": {"n_layer": 1, "n_embd": 16, "n_hidden": 32,
                                 "gqa_query_heads": 2, "kv_heads": 1, "gqa_head_dim": 8,
                                 "cross_query_heads": 2, "cross_head_dim": 8}},
           "data": {"text_length": 128, "audio_length": 128, "channels": 2,
                    "delay_pattern": [0, 1]}}
    gpt = dict(n_layer=1, n_head=2, n_embd=16, input_vocab_size=64, output_vocab_size=64)
    bark = dict(semantic_config=gpt, coarse_acoustics_config=gpt, fine_acoustics_config=gpt)
    soprano = dict(lm, model_type="qwen3", tie_word_embeddings=True, decoder_config=dict(
        decoder_num_layers=1, decoder_dim=8, decoder_intermediate_dim=16, hop_length=4,
        n_fft=16))
    spark = dict(llm=dict(lm, vocab_size=32))
    indextts = dict(gpt=dict(model_dim=16, heads=2, layers=1, max_mel_tokens=8,
                             max_text_tokens=8, number_text_tokens=16, number_mel_codes=16,
                             start_mel_token=14, stop_mel_token=15, condition_num_latent=2,
                             condition_module=dict(input_size=8, output_size=16, num_blocks=1,
                                                   linear_units=16, attention_heads=2)),
                    bigvgan=TINY_BIGVGAN)
    wav2vec = dict(vocab_size=8, hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                   intermediate_size=32, conv_dim=[8], conv_stride=[5], conv_kernel=[10],
                   num_conv_pos_embeddings=4, num_conv_pos_embedding_groups=2)
    return [(Whisper, whisper), (Qwen3TTS, qwen3), (MossFormer2SE, mossformer2_se),
            (Kokoro, kokoro), (Orpheus, dict(lm, model_type="llama")),
            (Vyvo, dict(lm, model_type="qwen3")), (Sesame, sesame), (Dia, dia),
            (OuteTTS, dict(lm, model_type="llama", tie_word_embeddings=True)), (Bark, bark),
            (Soprano, soprano), (Spark, spark), (Wav2Vec2, wav2vec), (IndexTTS, indextts)]


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a device argument every entry point asks for `cuda`, and
    raises rather than run on the host when there is no card."""
    import pytest
    import torch

    from mlx_audio_tpu_torch.codec.models import DAC, SNAC, BigVGAN, Encodec, Mimi, Vocos
    from mlx_audio_tpu_torch.tts.models.spark import BiCodec
    from mlx_audio_tpu_torch.codec.models.mimi import mimi

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    snac = dict(encoder_dim=4, encoder_rates=[2], decoder_dim=8, decoder_rates=[2],
                attn_window_size=None, codebook_size=8, codebook_dim=2, vq_strides=[1])
    tiny_mimi = mimi.MimiConfig(
        sample_rate=1600.0, frame_rate=200.0,
        seanet=mimi.SeanetConfig(dimension=8, nfilters=2, ratios=[2, 2]),
        transformer=mimi.TransformerConfig(d_model=8, num_heads=2, num_layers=1,
                                           dim_feedforward=16, context=4),
        quantizer_nq=2, quantizer_bins=4, quantizer_dim=4)
    dac = dict(encoder_dim=4, encoder_rates=[2], decoder_dim=8, decoder_rates=[2],
               n_codebooks=2, codebook_size=8, codebook_dim=2)
    encodec = dict(num_filters=2, hidden_size=4, codebook_size=8, codebook_dim=4,
                   upsampling_ratios=[2])
    vocos = {"feature_extractor": {"class_path": "MelSpectrogramFeatures",
                                   "init_args": {"n_mels": 8}},
             "backbone": {"init_args": dict(input_channels=8, dim=8, intermediate_dim=16,
                                            num_layers=1)},
             "head": {"init_args": dict(dim=8, n_fft=16, hop_length=4)}}
    from test_spark_checkpoint import TINY_CFG

    for cls, cfg in _tiny_entry_points() + [(lambda c, **kw: SNAC(**c, **kw), snac),
                                            (Mimi, tiny_mimi),
                                            (lambda c, **kw: DAC(**c, **kw), dac),
                                            (Encodec, encodec), (Vocos.from_hparams, vocos),
                                            (BiCodec.from_config,
                                             TINY_CFG["audio_tokenizer"]),
                                            (BigVGAN, TINY_BIGVGAN)]:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(cfg)
        assert cls(cfg, device="cpu").device.type == "cpu"


SERVING_MODULES = ("mlx_audio_tpu_torch.serving", "mlx_audio_tpu_torch.lm.continuous",
                   "mlx_audio_tpu_torch.tts.models.qwen3_tts.batcher")


def test_serving_modules_are_scanned():
    """The serving modules are among those the import and scan tests cover."""
    names = {name for _, name in _modules()}
    assert set(SERVING_MODULES) <= names


def test_batchers_follow_their_model_device(monkeypatch):
    """Every family's `make_batcher` on a model built with device='cpu' runs
    its worker on that device, with no card present: the batchers take the
    model's device and never ask for `cuda` themselves."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls, cfg in _tiny_entry_points():
        kw = {}
        if "talker_config" in cfg:  # text ids inside the tiny text vocabulary
            cfg = dict(cfg, tts_pad_token_id=5, tts_bos_token_id=6, tts_eos_token_id=7)
            kw = dict(slots=1, max_len=16)
        model = cls(cfg, device="cpu")
        batcher = model.make_batcher(**kw)
        try:
            # the scheduler: a BatchScheduler, a ContinuousBatcher, or the batcher
            worker = getattr(batcher, "sched", getattr(batcher, "cb", batcher))
            assert worker.device == torch.device("cpu"), cls
        finally:
            batcher.close()


SERVER_SLICE_MODULES = ("mlx_audio_tpu_torch.server", "mlx_audio_tpu_torch.ws",
                        "mlx_audio_tpu_torch.profiling", "mlx_audio_tpu_torch.tokenizer_json",
                        "mlx_audio_tpu_torch.stt.models.whisper.convert",
                        "mlx_audio_tpu_torch.tts.audio_player")


def test_server_slice_modules_are_scanned():
    """The server, its WebSocket codec, profiling, the tokenizer.json reader,
    the Whisper converter and the audio player are among the modules the
    import and scan tests cover, and the studio UI ships as package data."""
    names = {name for _, name in _modules()}
    assert set(SERVER_SLICE_MODULES) <= names
    assert (PKG / "ui" / "index.html").is_file()
    assert '"ui/*.html"' in (REPO / "pyproject.toml").read_text()


CODEC_SLICE_MODULES = ("mlx_audio_tpu_torch.codec.models.descript.dac",
                       "mlx_audio_tpu_torch.tts.models.dia.config",
                       "mlx_audio_tpu_torch.tts.models.dia.audio",
                       "mlx_audio_tpu_torch.tts.models.dia.layers",
                       "mlx_audio_tpu_torch.tts.models.dia.dia",
                       "mlx_audio_tpu_torch.tts.models.dia.batcher",
                       "mlx_audio_tpu_torch.tts.models.outetts.tokens",
                       "mlx_audio_tpu_torch.tts.models.outetts.prompt_processor",
                       "mlx_audio_tpu_torch.tts.models.outetts.outetts")


def test_codec_slice_modules_are_scanned():
    """DAC, Dia (with its batcher) and OuteTTS are among the modules the
    import and scan tests cover, and the loader resolves both families."""
    from mlx_audio_tpu_torch.utils import PORTED

    names = {name for _, name in _modules()}
    assert set(CODEC_SLICE_MODULES) <= names
    assert {"dia", "outetts"} <= set(PORTED["tts"])


def test_no_tokenizers_or_transformers_import_anywhere():
    """Text goes through the port's own tokenizer.json reader: no module of
    the port imports `tokenizers` or `transformers`, in a function either."""
    bad = []
    for path, module in _modules():
        for line, name in _absolute_imports(path, module):
            if name.split(".")[0] in ("tokenizers", "transformers"):
                bad.append(f"{path.relative_to(REPO)}:{line}: {name}")
    assert not bad, bad


def test_tokenizers_build_without_the_missing_packages(tmp_path):
    """With tokenizers and transformers unimportable, Whisper's tokenizer and
    Qwen3-TTS's text tokenizer build from a directory's tokenizer.json."""
    code = (
        "import sys\n"
        f"for n in {NOT_ON_THE_CARD!r}:\n"
        "    sys.modules[n] = None\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import importlib.util, pathlib\n"
        f"spec = importlib.util.spec_from_file_location('cs', {str(REPO / 'chip_smoke.py')!r})\n"
        "cs = importlib.util.module_from_spec(spec); spec.loader.exec_module(cs)\n"
        f"d = pathlib.Path({str(tmp_path)!r})\n"
        "(d / 'w').mkdir(); (d / 'q').mkdir()\n"
        "cs.write_tokenizer_json(d / 'w', 'whisper', n_merges=40)\n"
        "cs.write_tokenizer_json(d / 'q', 'qwen2', n_merges=40)\n"
        "from mlx_audio_tpu_torch.stt.models.whisper.tokenizer import WhisperTokenizer\n"
        "tok = WhisperTokenizer(d / 'w', language='en')\n"
        "assert tok.sot_sequence == (50258, 50259, 50360), tok.sot_sequence\n"
        "assert tok.decode(tok.encode(' hello world')) == ' hello world'\n"
        "from mlx_audio_tpu_torch.tts.models.qwen3_tts import Model\n"
        "m = Model.__new__(Model)\n"
        "m.config = type('C', (), {'model_path': str(d / 'q')})()\n"
        "assert m.tokenizer.encode('<|im_start|>assistant\\n')[0] == 151644\n"
        "assert not any(k.split('.')[0] in ('tokenizers', 'transformers') and sys.modules[k]\n"
        "               for k in sys.modules)\n"
        "print('OK')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "OK"


LM_CORE_SLICE_MODULES = (
    "mlx_audio_tpu_torch.lm.transformer", "mlx_audio_tpu_torch.lm.generate",
    "mlx_audio_tpu_torch.lm.sample", "mlx_audio_tpu_torch.nn.activations",
    "mlx_audio_tpu_torch.codec.models.base", "mlx_audio_tpu_torch.codec.models.snac.snac",
    "mlx_audio_tpu_torch.tts.models.snac_lm", "mlx_audio_tpu_torch.tts.models.llama.llama",
    "mlx_audio_tpu_torch.tts.models.qwen3.qwen3",
    "mlx_audio_tpu_torch.tts.models.qwen3_tts.speaker_encoder")


def test_lm_core_slice_modules_are_scanned():
    """The LM core, SNAC, the SNAC-LM families and Qwen3-TTS's speaker
    encoder are among the modules the import and scan tests cover."""
    names = {name for _, name in _modules()}
    assert set(LM_CORE_SLICE_MODULES) <= names


MIMI_SESAME_SLICE_MODULES = (
    "mlx_audio_tpu_torch.codec.models.mimi", "mlx_audio_tpu_torch.codec.models.mimi.mimi",
    "mlx_audio_tpu_torch.tts.models.sesame", "mlx_audio_tpu_torch.tts.models.sesame.sesame",
    "mlx_audio_tpu_torch.tts.models.sesame.batcher",
    "mlx_audio_tpu_torch.tts.models.sesame.watermarking",
    "mlx_audio_tpu_torch.tts.models.qwen3_tts.speech_tokenizer")


@pytest.mark.parametrize("name", MIMI_SESAME_SLICE_MODULES)
def test_mimi_sesame_slice_modules_are_scanned(name):
    """Mimi, Sesame (the model, its batcher and the watermark) and the
    speech tokenizer with its Mimi-based encoder are among the modules the
    import and scan tests cover."""
    assert name in {n for _, n in _modules()}


BARK_SLICE_MODULES = ("mlx_audio_tpu_torch.codec.models.encodec",
                      "mlx_audio_tpu_torch.codec.models.encodec.encodec",
                      "mlx_audio_tpu_torch.tts.models.bark",
                      "mlx_audio_tpu_torch.tts.models.bark.bark",
                      "mlx_audio_tpu_torch.tts.models.bark.batcher")


@pytest.mark.parametrize("name", BARK_SLICE_MODULES)
def test_bark_slice_modules_are_scanned(name):
    """EnCodec and Bark (the model and its batcher) are among the modules
    the import and scan tests cover, and the loader resolves Bark."""
    from mlx_audio_tpu_torch.utils import PORTED, get_model_class

    assert name in {n for _, n in _modules()}
    assert "bark" in PORTED["tts"]
    assert get_model_class("bark", None, "tts", {})[1] == "bark"


def test_wordpiece_reads_without_the_missing_packages(tmp_path):
    """With tokenizers and transformers unimportable, Bark's WordPiece text
    tokenizer reads a vocab.txt."""
    (tmp_path / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "hello", "world", "!"]) + "\n")
    code = (
        "import sys\n"
        f"for n in {NOT_ON_THE_CARD!r}:\n"
        "    sys.modules[n] = None\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from mlx_audio_tpu_torch.tokenizer_json import load\n"
        f"tok = load({str(tmp_path / 'vocab.txt')!r})\n"
        "assert tok.encode('hello world!') == [2, 5, 6, 7, 3], tok.encode('hello world!')\n"
        "print('OK')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "OK"


VOCOS_SPARK_SLICE_MODULES = (
    "mlx_audio_tpu_torch.codec.models.vocos", "mlx_audio_tpu_torch.codec.models.vocos.vocos",
    "mlx_audio_tpu_torch.tts.models.soprano", "mlx_audio_tpu_torch.tts.models.soprano.soprano",
    "mlx_audio_tpu_torch.tts.models.soprano.batcher",
    "mlx_audio_tpu_torch.tts.models.soprano.text", "mlx_audio_tpu_torch.tts.models.spark",
    "mlx_audio_tpu_torch.tts.models.spark.spark",
    "mlx_audio_tpu_torch.tts.models.spark.token_parser",
    "mlx_audio_tpu_torch.tts.models.spark.files", "mlx_audio_tpu_torch.stt.models.wav2vec",
    "mlx_audio_tpu_torch.stt.models.wav2vec.wav2vec", "mlx_audio_tpu_torch.stt.models.wav2vec2")


@pytest.mark.parametrize("name", VOCOS_SPARK_SLICE_MODULES)
def test_vocos_spark_slice_modules_are_scanned(name):
    """Vocos, Soprano (the model, its batcher, its text cleaner), Spark-TTS
    (the model, BiCodec, the token parser, the file helpers) and Wav2Vec2
    are among the modules the import and scan tests cover, and the loader
    resolves each family by its model type or its directory's name."""
    from mlx_audio_tpu_torch.utils import PORTED, get_model_class

    assert name in {n for _, n in _modules()}
    assert {"spark", "soprano"} <= set(PORTED["tts"])
    assert {"wav2vec", "wav2vec2"} <= set(PORTED["stt"])
    assert get_model_class("spark", None, "tts", {"spark": "spark"})[1] == "spark"
    assert get_model_class("qwen3", ["soprano", "1.1", "80m"], "tts",
                           {"soprano": "soprano"})[1] == "soprano"
    assert get_model_class("wav2vec2", None, "stt", {})[1] == "wav2vec2"


INDEXTTS_SLICE_MODULES = (
    "mlx_audio_tpu_torch.lm.gpt2", "mlx_audio_tpu_torch.codec.models.bigvgan",
    "mlx_audio_tpu_torch.codec.models.bigvgan.bigvgan", "mlx_audio_tpu_torch.tts.models.indextts",
    "mlx_audio_tpu_torch.tts.models.indextts.indextts",
    "mlx_audio_tpu_torch.tts.models.indextts.batcher",
    "mlx_audio_tpu_torch.tts.models.indextts.normalize")


@pytest.mark.parametrize("name", INDEXTTS_SLICE_MODULES)
def test_indextts_slice_modules_are_scanned(name):
    """GPT-2, BigVGAN and IndexTTS (the model, its batcher, its normalizer)
    are among the modules the import and scan tests cover, and the loader
    and the TTS registry find IndexTTS by its model type."""
    from mlx_audio_tpu_torch.tts.utils import get_available_models
    from mlx_audio_tpu_torch.utils import PORTED, get_model_class

    assert name in {n for _, n in _modules()}
    assert "indextts" in PORTED["tts"] and "indextts" in get_available_models()
    assert get_model_class("indextts", None, "tts", {})[1] == "indextts"


CHATTERBOX_SLICE_MODULES = (
    "mlx_audio_tpu_torch.codec.models.s3tokenizer",
    "mlx_audio_tpu_torch.codec.models.s3tokenizer.s3tokenizer",
    "mlx_audio_tpu_torch.codec.models.s3gen", "mlx_audio_tpu_torch.codec.models.s3gen.mel",
    "mlx_audio_tpu_torch.codec.models.s3gen.xvector",
    "mlx_audio_tpu_torch.codec.models.s3gen.encoder",
    "mlx_audio_tpu_torch.codec.models.s3gen.decoder",
    "mlx_audio_tpu_torch.codec.models.s3gen.flow_matching",
    "mlx_audio_tpu_torch.codec.models.s3gen.flow", "mlx_audio_tpu_torch.codec.models.s3gen.hifigan",
    "mlx_audio_tpu_torch.codec.models.s3gen.s3gen", "mlx_audio_tpu_torch.tts.models.chatterbox",
    "mlx_audio_tpu_torch.tts.models.chatterbox.config",
    "mlx_audio_tpu_torch.tts.models.chatterbox.tokenizer",
    "mlx_audio_tpu_torch.tts.models.chatterbox.voice_encoder",
    "mlx_audio_tpu_torch.tts.models.chatterbox.t3",
    "mlx_audio_tpu_torch.tts.models.chatterbox.chatterbox",
    "mlx_audio_tpu_torch.tts.models.chatterbox.batcher",
    "mlx_audio_tpu_torch.tts.models.chatterbox.convert")


@pytest.mark.parametrize("name", CHATTERBOX_SLICE_MODULES)
def test_chatterbox_slice_modules_are_scanned(name):
    """S3Tokenizer, S3Gen and Chatterbox (the model, T3, the voice encoder,
    the tokenizers, the config, the batcher, the converter) are among the
    modules the import and scan tests cover, and the loader and the TTS
    registry find Chatterbox by its model type."""
    from mlx_audio_tpu_torch.tts.utils import get_available_models
    from mlx_audio_tpu_torch.utils import PORTED, get_model_class

    assert name in {n for _, n in _modules()}
    assert "chatterbox" in PORTED["tts"] and "chatterbox" in get_available_models()
    assert get_model_class("chatterbox", None, "tts", {})[1] == "chatterbox"


def test_chatterbox_entry_points_default_to_the_card(monkeypatch):
    """Chatterbox, S3Token2Wav and S3TokenizerV2 ask for `cuda` without a
    device argument and raise with no card; Chatterbox's batcher runs on
    its model's device."""
    import torch

    from mlx_audio_tpu_torch.codec.models.s3gen import S3Token2Wav
    from mlx_audio_tpu_torch.codec.models.s3tokenizer import ModelConfig, S3TokenizerV2
    from mlx_audio_tpu_torch.tts.models.chatterbox import Model, ModelConfig as CBConfig

    from test_torch_chatterbox import T3_KW, TINY_SIZES
    from mlx_audio_tpu_torch.tts.models.chatterbox import T3Config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s3 = ModelConfig(n_mels=16, n_audio_state=16, n_audio_head=2, n_audio_layer=1)
    cb = CBConfig(t3_config=T3Config(**T3_KW))
    for make in (lambda **kw: S3TokenizerV2(config=s3, **kw),
                 lambda **kw: S3Token2Wav(sizes=TINY_SIZES, **kw),
                 lambda **kw: Model(cb, s3gen_sizes=TINY_SIZES, **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        assert make(device="cpu").device.type == "cpu"
    batcher = Model(cb, s3gen_sizes=TINY_SIZES, device="cpu").make_batcher()
    try:
        assert batcher.device == torch.device("cpu")
    finally:
        batcher.close()
