"""Text front end (port of ``pocket_tts_tpu/text.py``): a pure-Python Unigram
tokenizer over ``tokenizer.json``, prompt preparation and token-budgeted
sentence chunking.

The tokenizer reproduces what HF ``tokenizers`` does with that file:

* the special tokens (``<unk>``, ``<s>``, ``</s>``, ``<pad>``) are split out
  of the raw text first;
* Metaspace pre-tokenizer: every ``" "`` becomes ``"▁"``, no prefix is
  prepended and the text is not split;
* Unigram model: Viterbi over the scored pieces (unknown characters score
  ``min_score - 10``, runs of them are fused), then byte fallback of anything
  not in the vocabulary to ``<0xNN>`` pieces;
* TemplateProcessing post-processor: ``<s>`` (id 1) is prepended.

The tokenizer asset is read by file path from the JAX package's
``assets/`` folder (it is data, not code).
"""

from __future__ import annotations

import functools
import json
import os
import re
from pathlib import Path

import numpy as np

_ASSET_TOKENIZER = (Path(__file__).resolve().parent.parent / "pocket_tts_tpu" / "assets"
                    / "tokenizer.json")

# <= 50 tokens per chunk keeps attention cost linear in text length.
MAX_TOKENS_PER_CHUNK = 50

_UNK_PENALTY = 10.0
_BYTE_PIECE = re.compile(r"^<0x([0-9A-Fa-f]{2})>$")


class TextTokenizer:
    """Unigram + Metaspace + byte-fallback tokenizer read from ``tokenizer.json``."""

    def __init__(self, path: str | Path | None = None):
        path = Path(path or os.environ.get("POCKET_TTS_TOKENIZER", _ASSET_TOKENIZER))
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        model = spec["model"]
        if model["type"] != "Unigram":
            raise ValueError(f"{path}: expected a Unigram model, got {model['type']}")
        pre = spec["pre_tokenizer"]
        if pre["type"] != "Metaspace" or pre.get("split") or pre.get("prepend_scheme") != "never":
            raise ValueError(f"{path}: unsupported pre-tokenizer {pre}")
        self._replacement = pre["replacement"]
        vocab = model["vocab"]
        self._pieces = [piece for piece, _ in vocab]
        self._scores = [float(score) for _, score in vocab]
        self._ids = {piece: i for i, piece in enumerate(self._pieces)}
        self._max_len = max(len(p) for p in self._pieces)
        self._unk_id = model["unk_id"]
        self._unk_score = min(self._scores) - _UNK_PENALTY
        self._byte_fallback = bool(model.get("byte_fallback"))
        specials = [t for t in spec["added_tokens"] if t["special"]]
        self._special_ids = {t["id"] for t in specials}
        by_len = sorted((t["content"] for t in specials), key=len, reverse=True)
        self._special_re = re.compile("(" + "|".join(map(re.escape, by_len)) + ")")
        self._bos = [self._ids[t] for t in self._template_prefix(spec["post_processor"])]

    @staticmethod
    def _template_prefix(post: dict) -> list[str]:
        if post is None:
            return []
        if post["type"] != "TemplateProcessing":
            raise ValueError(f"unsupported post-processor {post['type']}")
        prefix = []
        for item in post["single"]:
            if "Sequence" in item:
                break
            prefix.append(item["SpecialToken"]["id"])
        return prefix

    @property
    def vocab_size(self) -> int:
        return len(self._pieces)

    def _viterbi(self, s: str) -> list[str]:
        """Best segmentation of ``s`` into pieces (unknown runs fused)."""
        n = len(s)
        best_score = [0.0] * (n + 1)
        start = [-1] * (n + 1)
        node_id = [0] * (n + 1)
        for i in range(n):
            base = best_score[i]
            has_single = False
            for j in range(i + 1, min(n, i + self._max_len) + 1):
                pid = self._ids.get(s[i:j])
                if pid is None:
                    continue
                cand = base + self._scores[pid]
                if start[j] < 0 or cand > best_score[j]:
                    best_score[j], start[j], node_id[j] = cand, i, pid
                if j == i + 1:
                    has_single = True
            if not has_single:
                cand = base + self._unk_score
                if start[i + 1] < 0 or cand > best_score[i + 1]:
                    best_score[i + 1], start[i + 1], node_id[i + 1] = cand, i, self._unk_id
        pieces: list[str] = []
        unk_run: list[str] = []
        end = n
        while end > 0:
            st = start[end]
            if node_id[end] == self._unk_id:
                unk_run.append(s[st:end])
            else:
                if unk_run:
                    pieces.append("".join(reversed(unk_run)))
                    unk_run = []
                pieces.append(s[st:end])
            end = st
        if unk_run:
            pieces.append("".join(reversed(unk_run)))
        return pieces[::-1]

    def _encode_segment(self, text: str) -> list[int]:
        ids: list[int] = []
        for piece in self._viterbi(text.replace(" ", self._replacement)):
            pid = self._ids.get(piece)
            if pid is not None:
                ids.append(pid)
            elif self._byte_fallback:
                ids.extend(self._ids[f"<0x{b:02X}>"] for b in piece.encode("utf-8"))
            else:
                ids.append(self._unk_id)
        return ids

    def encode(self, text: str) -> list[int]:
        ids = list(self._bos)
        for part in self._special_re.split(text):
            if not part:
                continue
            if part in self._ids and self._ids[part] in self._special_ids:
                ids.append(self._ids[part])
            else:
                ids.extend(self._encode_segment(part))
        return ids

    def decode(self, ids: list[int]) -> str:
        """Special tokens skipped; ``▁`` -> space; byte pieces fused into UTF-8
        (one U+FFFD per byte of an invalid run)."""
        out: list[str] = []
        pending = bytearray()

        def flush():
            if pending:
                try:
                    out.append(pending.decode("utf-8"))
                except UnicodeDecodeError:
                    out.append("�" * len(pending))
                pending.clear()

        for i in ids:
            i = int(i)
            if i in self._special_ids:
                continue
            piece = self._pieces[i].replace(self._replacement, " ")
            m = _BYTE_PIECE.match(piece)
            if m:
                pending.append(int(m.group(1), 16))
            else:
                flush()
                out.append(piece)
        flush()
        return "".join(out)

    def count_tokens(self, text: str) -> int:
        return len(self.encode(text))


@functools.lru_cache(maxsize=4)
def load_tokenizer(path: str | None = None) -> TextTokenizer:
    return TextTokenizer(path)


def prepare_text_prompt(text: str) -> tuple[str, int]:
    """Normalize a prompt and guess frames_after_eos."""
    text = text.strip()
    if text == "":
        raise ValueError("Text prompt cannot be empty")
    text = text.replace("\n", " ").replace("\r", " ").replace("  ", " ")
    number_of_words = len(text.split())
    frames_after_eos_guess = 3 if number_of_words <= 4 else 1

    if not text[0].isupper():
        text = text[0].upper() + text[1:]
    if text[-1].isalnum():
        text = text + "."
    # the model underperforms on very short prompts; pad with leading spaces
    if len(text.split()) < 5:
        text = " " * 8 + text
    return text, frames_after_eos_guess


def split_into_best_sentences(tokenizer: TextTokenizer, text_to_generate: str) -> list[str]:
    """Token-budgeted sentence chunking (the reference's token-based definition)."""
    text_to_generate, _ = prepare_text_prompt(text_to_generate)
    text_to_generate = text_to_generate.strip()
    tokens = tokenizer.encode(text_to_generate)

    # first id is the <s> prefix: skip it
    end_of_sentence_tokens = set(tokenizer.encode(".!...?")[1:])

    end_indices = [0]
    prev_was_eos = False
    for idx, token in enumerate(tokens):
        if token in end_of_sentence_tokens:
            prev_was_eos = True
        else:
            if prev_was_eos:
                end_indices.append(idx)
            prev_was_eos = False
    end_indices.append(len(tokens))

    sentences = []
    for start, end in zip(end_indices[:-1], end_indices[1:]):
        # a sentence with no internal punctuation can exceed the budget on
        # its own: hard-split it at the token level
        for s in range(start, end, MAX_TOKENS_PER_CHUNK):
            e = min(s + MAX_TOKENS_PER_CHUNK, end)
            sentences.append((e - s, tokenizer.decode(tokens[s:e])))

    # budgets use the ORIGINAL token counts; emitted chunks re-encode to up to
    # ~54 tokens, inside the largest text bucket (64)
    chunks: list[str] = []
    current = ""
    current_tokens = 0
    for n_tokens, sentence in sentences:
        if current == "":
            current, current_tokens = sentence, n_tokens
            continue
        if current_tokens + n_tokens > MAX_TOKENS_PER_CHUNK:
            chunks.append(current.strip())
            current, current_tokens = sentence, n_tokens
        else:
            current += " " + sentence
            current_tokens += n_tokens
    if current != "":
        chunks.append(current.strip())
    return chunks


def max_generation_frames(text: str) -> int:
    """Generation budget: (words + 2 s) * 12.5 frames/s."""
    return int((len(text.split()) + 2.0) * 12.5)


def tokens_array(tokenizer: TextTokenizer, text: str, bucket: int | None = None
                 ) -> tuple[np.ndarray, int]:
    """Encode to a right-padded int32 array of length ``bucket`` (pad id 0;
    padded positions are never attended)."""
    ids = tokenizer.encode(text)
    n = len(ids)
    if bucket is None:
        bucket = n
    if n > bucket:
        raise ValueError(f"{n} tokens exceed bucket {bucket}")
    out = np.zeros((1, bucket), np.int32)
    out[0, :n] = ids
    return out, n
