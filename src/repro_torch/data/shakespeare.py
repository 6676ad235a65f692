"""Shakespeare-style char-LM task: text -> token sequences with
per-speaker natural partitions.

Real data is a plain-text corpus of plays under ``data_root`` (a
``shakespeare.txt``, or any single ``*.txt``) in the usual
tinyshakespeare / LEAF layout where a speaker turn starts with a
``Speaker Name:`` line::

    First Citizen:
    Before we proceed any further, hear me speak.

The parser attributes each speech to its speaker, builds a character
vocabulary over the whole corpus, and windows every speaker's stream
into ``seq_len + 1`` chunks (inputs = ``[:-1]``, next-char labels =
``[1:]``).  Per-sequence speaker ids land in ``metadata["natural_ids"]``
so the ``natural`` partitioner reproduces the paper's
one-client-per-speaker regime.

Without files the loader generates a deterministic synthetic corpus:
each synthetic speaker samples from its own sparse bigram transition
table (the base table with rotated columns), so the natural partition
is genuinely non-IID while CI stays offline.  Outputs are cached as npz
keyed by (task, seed, preprocessing) — see :mod:`repro_torch.data.cache`.
"""

from __future__ import annotations

import hashlib
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.data.base import FederatedDataset, register_dataset
from repro_torch.data.cache import cached

_SPEAKER_RE = re.compile(r"^([A-Z][A-Za-z .'-]{0,40}):\s*$")


def _find_corpus(root: Path) -> Optional[Path]:
    named = root / "shakespeare.txt"
    if named.exists():
        return named
    txts = sorted(root.glob("*.txt"))
    return txts[0] if txts else None


def _parse_speakers(text: str) -> List[Tuple[str, str]]:
    """(speaker, speech) turns; prologue text before any speaker is dropped."""
    turns: List[Tuple[str, str]] = []
    speaker, lines = None, []
    for line in text.splitlines():
        m = _SPEAKER_RE.match(line.strip())
        if m:
            if speaker and lines:
                turns.append((speaker, "\n".join(lines)))
            speaker, lines = m.group(1), []
        elif speaker is not None:
            if line.strip():
                lines.append(line.strip())
    if speaker and lines:
        turns.append((speaker, "\n".join(lines)))
    return turns


def _window(stream: np.ndarray, seq_len: int) -> np.ndarray:
    """Non-overlapping (n, seq_len+1) windows of an encoded char stream."""
    step = seq_len + 1
    n = len(stream) // step
    return stream[: n * step].reshape(n, step) if n else \
        np.empty((0, step), np.int32)


def _from_text(text: str, seq_len: int, min_sequences: int,
               holdout: float) -> Dict[str, np.ndarray]:
    chars = sorted(set(text))
    lut = np.zeros(1 << 21, np.int32)  # direct codepoint -> id table
    for i, c in enumerate(chars):
        lut[ord(c)] = i
    turns = _parse_speakers(text)
    by_speaker: Dict[str, List[str]] = {}
    for speaker, speech in turns:
        by_speaker.setdefault(speaker, []).append(speech)

    train, test, ids = [], [], []
    speaker_idx = 0
    for speaker in sorted(by_speaker):
        stream = "\n".join(by_speaker[speaker])
        codes = lut[np.frombuffer(stream.encode("utf-32-le"), np.uint32)]
        seqs = _window(codes.astype(np.int32), seq_len)
        if len(seqs) < min_sequences:
            continue
        n_te = max(1, int(round(holdout * len(seqs)))) if len(seqs) > 1 else 0
        split = len(seqs) - n_te
        train.append(seqs[:split])
        test.append(seqs[split:])
        ids.append(np.full(split, speaker_idx, np.int32))
        speaker_idx += 1
    if not train:
        raise ValueError("no speaker produced enough sequences; "
                         "check the corpus format / seq_len")
    return {"train": np.concatenate(train), "test": np.concatenate(test),
            "natural_ids": np.concatenate(ids),
            "vocab_chars": np.frombuffer(
                "".join(chars).encode("utf-32-le"), np.uint32)}


def _synthetic_fallback(seed: int, seq_len: int, vocab: int,
                        num_speakers: int, train_size: int,
                        test_size: int) -> Dict[str, np.ndarray]:
    """Per-speaker sparse-bigram sequences (vectorized, deterministic)."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 1, (vocab, vocab))
    top = np.argsort(-logits, axis=1)[:, :4]
    base = np.zeros_like(logits)
    rows = np.arange(vocab)[:, None]
    base[rows, top] = [0.55, 0.25, 0.15, 0.05]
    # speaker s speaks from the base dynamics with rotated columns:
    # same sparsity/entropy, different transitions -> natural non-IID
    tables = np.stack([np.roll(base, s, axis=1) for s in range(num_speakers)])
    ctabs = np.cumsum(tables, axis=-1)

    def gen(n_per_speaker: int) -> Tuple[np.ndarray, np.ndarray]:
        n = n_per_speaker * num_speakers
        ids = np.repeat(np.arange(num_speakers, dtype=np.int32),
                        n_per_speaker)
        seqs = np.zeros((n, seq_len + 1), np.int32)
        state = rng.integers(0, vocab, n)
        seqs[:, 0] = state
        for t in range(1, seq_len + 1):
            u = rng.random(n)
            cum = ctabs[ids, state]  # (n, vocab) cumulative rows
            state = np.argmax(u[:, None] < cum, axis=1).astype(np.int64)
            seqs[:, t] = state
        return seqs, ids

    n_tr = max(1, train_size // num_speakers)
    n_te = max(1, test_size // num_speakers)
    train, ids = gen(n_tr)
    test, _ = gen(n_te)
    return {"train": train, "test": test, "natural_ids": ids,
            "vocab_chars": np.arange(vocab, dtype=np.uint32)}


@register_dataset("shakespeare")
def load_shakespeare(data_root=None, cache_dir=None, seed: int = 0,
                     seq_len: int = 32, vocab: int = 64,
                     num_speakers: int = 16, train_size: int = 2000,
                     test_size: int = 400, min_sequences: int = 2,
                     holdout: float = 0.1) -> FederatedDataset:
    """Char-LM corpus (or its stand-in) as a FederatedDataset.

    ``vocab``/``num_speakers``/``train_size``/``test_size`` only shape
    the synthetic fallback; with real files the vocabulary and speaker
    set come from the corpus.
    """
    root = Path(data_root) if data_root else None
    corpus = _find_corpus(root) if root is not None else None
    if corpus is not None:
        text = corpus.read_text(encoding="utf-8", errors="ignore")
        fields = dict(sha1=hashlib.sha1(text.encode()).hexdigest(),
                      seq_len=seq_len, min_sequences=min_sequences,
                      holdout=holdout)
        arrays, _ = cached(
            "shakespeare", fields,
            lambda: _from_text(text, seq_len, min_sequences, holdout),
            cache_dir)
        source = "files"
    else:
        fields = dict(seed=seed, seq_len=seq_len, vocab=vocab,
                      num_speakers=num_speakers, train_size=train_size,
                      test_size=test_size)
        arrays, _ = cached(
            "shakespeare", fields,
            lambda: _synthetic_fallback(seed, seq_len, vocab, num_speakers,
                                        train_size, test_size),
            cache_dir)
        source = "synthetic"
    train, test = arrays["train"], arrays["test"]
    ids = arrays["natural_ids"]
    vocab_size = len(arrays["vocab_chars"])
    return FederatedDataset(
        name="shakespeare",
        splits={"train": (train[:, :-1], train[:, 1:]),
                "test": (test[:, :-1], test[:, 1:])},
        metadata={"modality": "text", "vocab": vocab_size,
                  "seq_len": train.shape[1] - 1, "natural_ids": ids,
                  "partition_labels": ids, "num_speakers": int(ids.max()) + 1,
                  "source": source, "seed": seed},
    )
