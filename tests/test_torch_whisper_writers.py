"""The port's transcript writers (a copy of the JAX package's writers.py)
write byte-identical files in all five formats, with and without word
timings, under the word options that tests/test_writers.py uses."""

import pytest

from mlx_audio_tpu.stt.models.base import STTOutput as JaxSTTOutput
from mlx_audio_tpu.stt.models.whisper import writers as jax_writers
from mlx_audio_tpu_torch.stt.models.base import STTOutput
from mlx_audio_tpu_torch.stt.models.whisper import writers

WORDS = [{"word": f" w{i}", "start": i * 0.5, "end": i * 0.5 + 0.4, "probability": 0.9}
         for i in range(6)]
SEGMENTS = [
    {"id": 0, "seek": 0, "start": 0.0, "end": 1.4, "text": " w0 w1 w2",
     "tokens": [1, 2, 3], "words": WORDS[:3]},
    {"id": 1, "seek": 150, "start": 1.5, "end": 3661.25, "text": " w3\tw4 --> w5",
     "tokens": [4, 5, 6], "words": WORDS[3:]},
]
OPTIONS = {
    "plain": {},
    "width5_count1": dict(max_line_width=5, max_line_count=1),
    "width8_count2": dict(max_line_width=8, max_line_count=2),
    "highlight": dict(highlight_words=True),
    "words_per_line": dict(max_words_per_line=2),
}


def _outputs(words: bool):
    segs = [dict(s) if words else {k: v for k, v in s.items() if k != "words"}
            for s in SEGMENTS]
    text = "".join(s["text"] for s in segs).strip()
    return (STTOutput(text=text, segments=segs, language="en"),
            JaxSTTOutput(text=text, segments=segs, language="en"))


@pytest.mark.parametrize("fmt", ["txt", "vtt", "srt", "tsv", "json"])
@pytest.mark.parametrize("words", [True, False], ids=["words", "segments"])
@pytest.mark.parametrize("opt", list(OPTIONS))
def test_writers_byte_identical(tmp_path, fmt, words, opt):
    ours, theirs = _outputs(words)
    a = writers.get_writer(fmt, str(tmp_path / "port"))(ours, "talk.wav", **OPTIONS[opt])
    b = jax_writers.get_writer(fmt, str(tmp_path / "jax"))(theirs, "talk.wav", **OPTIONS[opt])
    assert a.name == b.name == f"talk.{fmt}"
    assert a.read_bytes() == b.read_bytes() and a.stat().st_size > 0


def test_write_all(tmp_path):
    ours, theirs = _outputs(True)
    writers.get_writer("all", str(tmp_path / "port"))(ours, "talk.wav", max_line_width=8)
    jax_writers.get_writer("all", str(tmp_path / "jax"))(theirs, "talk.wav", max_line_width=8)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == [f"talk.{e}" for e in ("json", "srt", "tsv", "txt", "vtt")]
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes()


def test_format_timestamp():
    for s in (0.0, 0.0004, 59.9996, 3661.25, 7322.5):
        for hours in (False, True):
            for marker in (".", ","):
                assert writers.format_timestamp(s, hours, marker) == \
                    jax_writers.format_timestamp(s, hours, marker)
