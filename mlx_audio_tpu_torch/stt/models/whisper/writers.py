"""Transcript writers: txt / srt / vtt / tsv / json (a copy of
`mlx_audio_tpu/stt/models/whisper/writers.py`, kept here so the port never
imports the JAX package)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

__all__ = ["get_writer", "format_timestamp"]


def format_timestamp(seconds: float, always_include_hours: bool = False,
                     decimal_marker: str = ".") -> str:
    assert seconds >= 0
    ms = round(seconds * 1000.0)
    hours, ms = divmod(ms, 3_600_000)
    minutes, ms = divmod(ms, 60_000)
    secs, ms = divmod(ms, 1_000)
    hours_marker = f"{hours:02d}:" if always_include_hours or hours > 0 else ""
    return f"{hours_marker}{minutes:02d}:{secs:02d}{decimal_marker}{ms:03d}"


class ResultWriter:
    extension: str = "txt"

    def __init__(self, output_dir: str):
        self.output_dir = Path(output_dir)

    def __call__(self, result, audio_path: str, **kwargs):
        self.output_dir.mkdir(parents=True, exist_ok=True)
        out = self.output_dir / (Path(audio_path).stem + "." + self.extension)
        with open(out, "w", encoding="utf-8") as f:
            self.write_result(result, f, **kwargs)
        return out

    def write_result(self, result, file, **kwargs):
        raise NotImplementedError


class WriteTXT(ResultWriter):
    extension = "txt"

    def write_result(self, result, file, **kwargs):
        for segment in result.segments or [{"text": result.text}]:
            print(segment["text"].strip(), file=file, flush=True)


def _group_words_into_subtitles(segments, max_line_width, max_line_count,
                                max_words_per_line):
    """Group word timings into subtitle blocks: lines wrap at `max_line_width`
    chars, blocks break at `max_line_count` lines, at >3 s pauses (when
    line limits are set), or at segment boundaries (when they are not)."""
    preserve_segments = max_line_count is None or max_line_width is None
    width = max_line_width or 1000
    per_line = max_words_per_line or 1000

    subtitle = []
    line_len = 0
    line_count = 1
    starts = [w["start"] for s in segments for w in s.get("words", [])]
    last = starts[0] if starts else 0.0
    for segment in segments:
        words = segment.get("words", [])
        for chunk_index in range(0, len(words), per_line):
            for i, original in enumerate(words[chunk_index:
                                               chunk_index + per_line]):
                timing = dict(original)
                long_pause = (not preserve_segments
                              and timing["start"] - last > 3.0)
                has_room = line_len + len(timing["word"]) <= width
                seg_break = i == 0 and subtitle and preserve_segments
                if line_len > 0 and has_room and not long_pause \
                        and not seg_break:
                    line_len += len(timing["word"])
                else:
                    timing["word"] = timing["word"].strip()
                    if (subtitle and max_line_count is not None
                            and (long_pause or line_count >= max_line_count)
                            or seg_break):
                        yield subtitle
                        subtitle = []
                        line_count = 1
                    elif line_len > 0:
                        line_count += 1
                        timing["word"] = "\n" + timing["word"]
                    line_len = len(timing["word"].strip())
                subtitle.append(timing)
                last = timing["start"]
    if subtitle:
        yield subtitle


class SubtitlesWriter(ResultWriter):
    """Shared VTT/SRT logic incl. word-level subtitle options."""

    always_include_hours: bool = False
    decimal_marker: str = "."

    def _ts(self, seconds: float) -> str:
        return format_timestamp(seconds, self.always_include_hours,
                                self.decimal_marker)

    def iterate_result(self, result, options: Optional[dict] = None, *,
                       max_line_width: Optional[int] = None,
                       max_line_count: Optional[int] = None,
                       highlight_words: bool = False,
                       max_words_per_line: Optional[int] = None):
        """Yield (start, end, text) cues. With word timestamps present,
        cues follow the line/word wrapping options; `highlight_words`
        emits one cue per word with the active word <u>underlined</u>."""
        import re

        options = options or {}
        max_line_width = max_line_width or options.get("max_line_width")
        max_line_count = max_line_count or options.get("max_line_count")
        highlight_words = highlight_words or options.get(
            "highlight_words", False)
        max_words_per_line = max_words_per_line or options.get(
            "max_words_per_line")

        segments = result.segments or []
        if segments and segments[0].get("words"):
            for subtitle in _group_words_into_subtitles(
                    segments, max_line_width, max_line_count,
                    max_words_per_line):
                sub_start = self._ts(subtitle[0]["start"])
                sub_end = self._ts(subtitle[-1]["end"])
                text = "".join(w["word"] for w in subtitle)
                if not highlight_words:
                    yield sub_start, sub_end, text
                    continue
                last = sub_start
                all_words = [w["word"] for w in subtitle]
                for i, w in enumerate(subtitle):
                    start, end = self._ts(w["start"]), self._ts(w["end"])
                    if last != start:
                        yield last, start, text
                    yield start, end, "".join(
                        re.sub(r"^(\s*)(.*)$", r"\1<u>\2</u>", word)
                        if j == i else word
                        for j, word in enumerate(all_words))
                    last = end
        else:
            for seg in segments:
                yield (self._ts(seg["start"]), self._ts(seg["end"]),
                       seg["text"].strip().replace("-->", "->"))


class WriteVTT(SubtitlesWriter):
    extension = "vtt"

    def write_result(self, result, file, **kwargs):
        print("WEBVTT\n", file=file)
        for start, end, text in self.iterate_result(result, **kwargs):
            print(f"{start} --> {end}\n{text}\n", file=file, flush=True)


class WriteSRT(SubtitlesWriter):
    extension = "srt"
    always_include_hours = True
    decimal_marker = ","

    def write_result(self, result, file, **kwargs):
        for i, (start, end, text) in enumerate(
                self.iterate_result(result, **kwargs), start=1):
            print(f"{i}\n{start} --> {end}\n{text}\n", file=file,
                  flush=True)


class WriteTSV(ResultWriter):
    extension = "tsv"

    def write_result(self, result, file, **kwargs):
        print("start", "end", "text", sep="\t", file=file)
        for seg in result.segments or []:
            print(
                round(1000 * seg["start"]), round(1000 * seg["end"]),
                seg["text"].strip().replace("\t", " "), sep="\t", file=file,
            )


class WriteJSON(ResultWriter):
    extension = "json"

    def write_result(self, result, file, **kwargs):
        json.dump(
            {
                "text": result.text,
                "segments": result.segments,
                "language": result.language,
            },
            file,
            ensure_ascii=False,
            indent=2,
        )


def get_writer(output_format: str, output_dir: str):
    writers = {
        "txt": WriteTXT, "vtt": WriteVTT, "srt": WriteSRT,
        "tsv": WriteTSV, "json": WriteJSON,
    }
    if output_format == "all":
        all_writers = [w(output_dir) for w in writers.values()]

        def write_all(result, audio_path, **kwargs):
            for w in all_writers:
                w(result, audio_path, **kwargs)

        return write_all
    return writers[output_format](output_dir)
