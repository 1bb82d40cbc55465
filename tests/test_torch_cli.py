"""The port's two generate CLIs (`stt.generate`, `tts.generate`) against the
JAX package's, run through `main(argv)` on one small checkpoint directory
each (written by the JAX package) and one wav.

Neither directory holds a tokenizer file: both packages' Whisper
tokenizers are their `DummyTokenizer`, and both Qwen3-TTS
models the same deterministic text tokenizer through `set_runtime`, which
reaches every instance. The port's
CLIs take `--device cpu` (the JAX package's have no such flag). Texts are
identical, and so are the transcript writers' files byte for byte (txt,
srt, vtt, tsv) and the JSON's fields, but for the model's float scores
(no_speech_prob, avg_logprob, ...), float32 sums in other orders held to
1e-5 relative (the writers themselves are byte-identical on one result:
tests/test_torch_whisper_writers.py). The written wavs are PCM-16 of float32 audio within 1e-4 of each other, so
their samples may part by one int16 step.
"""

import json

import numpy as np
import pytest

from mlx_audio_tpu import audio_io as jio
from mlx_audio_tpu.stt import generate as jstt
from mlx_audio_tpu.stt.models.whisper import tokenizer as jtokenizer
from mlx_audio_tpu.stt.models.whisper.tokenizer import DummyTokenizer as JaxTok
from mlx_audio_tpu.tts import generate as jtts
from mlx_audio_tpu_torch import audio_io as pio
from mlx_audio_tpu_torch.stt import generate as pstt
from mlx_audio_tpu_torch.stt.models.whisper import tokenizer as ptokenizer
from mlx_audio_tpu_torch.stt.models.whisper.tokenizer import DummyTokenizer
from mlx_audio_tpu_torch.tts import generate as ptts
from mlx_audio_tpu_torch.tts.models.qwen3_tts import Model as Qwen
from test_torch_loader import (jax_tokenizer, one_torch_thread,  # noqa: F401  (fixtures)
                               qwen_jax, whisper_jax)
from test_torch_qwen3_tts import TEXT, Tok

@pytest.fixture
def dummy_tokenizers(monkeypatch):
    """Each package's WhisperTokenizer (read from the checkpoint's
    tokenizer.json) replaced by its DummyTokenizer, whatever the entry point."""
    monkeypatch.setattr(jtokenizer, "WhisperTokenizer",
                        lambda *a, language="en", **k: JaxTok(n_vocab=51866, language=language))
    monkeypatch.setattr(ptokenizer, "WhisperTokenizer",
                        lambda *a, language="en", **k: DummyTokenizer(n_vocab=51866,
                                                                     language=language))


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    """4 s of a modulated tone at 44.1 kHz stereo, PCM-16: the CLIs downmix
    and resample it."""
    t = np.arange(44100 * 4) / 44100
    x = 0.3 * np.sin(2 * np.pi * 220 * t) * (1 + np.sin(2 * np.pi * 1.5 * t))
    path = tmp_path_factory.mktemp("audio") / "clip.wav"
    jio.write(path, np.stack([x, 0.5 * x], 1), 44100)
    return path


@pytest.mark.parametrize("mode", [[], ["--chunked"]], ids=["seek", "chunked"])
def test_stt_main_matches_jax(whisper_jax, wav, tmp_path, capsys, dummy_tokenizers, mode):
    _, d = whisper_jax
    # without timestamps the random weights' greedy tokens are text
    args = ["--model", str(d), "--audio", str(wav), "--format", "all", "--language", "en",
            "--temperature", "0", "--gen-kwargs", '{"without_timestamps": true}', *mode]
    jstt.main(args + ["--output-path", str(tmp_path / "j")])
    ref = capsys.readouterr().out
    pstt.main(args + ["--output-path", str(tmp_path / "p"), "--device", "cpu"])
    out = capsys.readouterr().out
    text = (tmp_path / "j" / "clip.txt").read_text()
    assert text.strip() and text.strip() in out and text.strip() in ref
    for ext in ("txt", "srt", "vtt", "tsv"):
        assert (tmp_path / "p" / f"clip.{ext}").read_bytes() == \
            (tmp_path / "j" / f"clip.{ext}").read_bytes(), ext
    ours = json.loads((tmp_path / "p" / "clip.json").read_text())
    theirs = json.loads((tmp_path / "j" / "clip.json").read_text())
    assert ours["text"] == theirs["text"] and len(ours["segments"]) == len(theirs["segments"])
    for a, b in zip(ours["segments"], theirs["segments"]):
        assert sorted(a) == sorted(b)
        for k in b:
            if isinstance(b[k], float):  # model scores: float32 in other summation orders
                assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-7), k
            else:
                assert a[k] == b[k], k
    assert "x realtime" in out and "peak memory 0.000 GB" in out


def test_generate_transcription_takes_a_tokenizer(whisper_jax, wav):
    """The library call forwards a tokenizer (and other decode options) to
    the model, as the card's run passes one in."""
    _, d = whisper_jax
    r = pstt.generate_transcription(model_path=str(d), audio=str(wav), chunked=True,
                                    language="en", tokenizer=DummyTokenizer(n_vocab=51866),
                                    verbose=False, device="cpu")
    assert r.segments and r.language == "en"


@pytest.fixture
def port_tokenizer():
    """The port's text tokenizer set before the CLI loads its model: as in
    the JAX package, it is the class's, which `set_runtime` sets."""
    saved = Qwen._tokenizer
    Qwen._tokenizer = Tok()
    yield
    Qwen._tokenizer = saved


def test_tts_main_matches_jax(qwen_jax, tmp_path, capsys, jax_tokenizer, port_tokenizer):
    _, d = qwen_jax
    args = ["--model", str(d), "--text", TEXT, "--temperature", "0", "--max_tokens", "8"]
    jtts.main(args + ["--output_path", str(tmp_path / "j")])
    ptts.main(args + ["--output_path", str(tmp_path / "p"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "wrote" in out and "rtf=" in out
    ref, ref_sr = jio.read(tmp_path / "j" / "audio_000.wav", dtype="int16")
    got, sr = pio.read(tmp_path / "p" / "audio_000.wav", dtype="int16")
    assert sr == ref_sr == 24000 and got.shape == ref.shape and got.size > 0
    assert np.abs(got.astype(np.int32) - ref).max() <= 1


def test_tts_join_audio_and_refusals(qwen_jax, tmp_path, port_tokenizer):
    """`join_audio` writes one file; `--play` raises where `sounddevice` (or
    an output device) is missing, as here; a reference audio without its text is transcribed with an STT
    model loaded through the port's loader, before the ICL route raises for
    want of the speech tokenizer's encoder, which this checkpoint lacks."""
    _, d = qwen_jax
    res = ptts.generate_audio(TEXT, model_path=str(d), temperature=0.0, max_tokens=4,
                              join_audio=True, output_path=str(tmp_path), verbose=False,
                              device="cpu")
    x, sr = pio.read(tmp_path / "audio.wav")
    assert len(res) == 1 and x.shape == (res[0].samples,) and sr == 24000
    with pytest.raises(RuntimeError, match="sounddevice"):
        ptts.main(["--model", str(d), "--text", TEXT, "--play", "--device", "cpu"])

    seen = []

    class Stt:
        def generate(self, wav):
            seen.append(wav.shape)
            return type("R", (), {"text": "hello"})()

    with pytest.raises(ValueError, match="ICL"):
        ptts.generate_audio(TEXT, model_path=str(d), ref_audio=str(tmp_path / "audio.wav"),
                            stt_model=Stt(), output_path=str(tmp_path), device="cpu")
    assert seen == [(-(-x.shape[0] * 16000 // 24000),)]  # resample_poly rounds up


def test_speech_boundaries_match_jax():
    rng = np.random.default_rng(0)
    sr = 16000
    x = np.concatenate([np.zeros(4000), 0.5 * rng.standard_normal(8000), np.zeros(6000)])
    x = x.astype(np.float32)
    assert ptts.detect_speech_boundaries(x, sr) == jtts.detect_speech_boundaries(x, sr)
    np.testing.assert_array_equal(ptts.remove_silence_on_both_ends(x, sr),
                                  jtts.remove_silence_on_both_ends(x, sr))
    with pytest.raises(ValueError, match="only silence"):
        ptts.detect_speech_boundaries(np.zeros(1000, np.float32), sr)
    np.testing.assert_array_equal(ptts.hertz_to_mel([0, 440, 8000]),
                                  jtts.hertz_to_mel([0, 440, 8000]))


def test_cli_flags_are_the_jax_packages():
    """Every flag of the JAX package's CLIs parses the same in the port's
    (which add --device and --dtype)."""
    argv = ["--model", "m", "--audio", "a.wav", "--word-timestamps", "--chunked",
            "--max-tokens", "5", "--gen-kwargs", '{"beam_size": 2}', "--stream"]
    ours, theirs = vars(pstt.parse_args(argv)), vars(jstt.parse_args(argv))
    assert {k: v for k, v in ours.items() if k not in ("device", "dtype")} == theirs
    argv = ["--text", "hi", "--voice", "af", "--speed", "1.2", "--join_audio", "--seed", "3"]
    ours, theirs = vars(ptts.parse_args(argv)), vars(jtts.parse_args(argv))
    assert {k: v for k, v in ours.items() if k not in ("device", "dtype")} == theirs
    assert pstt.parse_args(["--audio", "a", "--dtype", "bfloat16"]).dtype == "bfloat16"
