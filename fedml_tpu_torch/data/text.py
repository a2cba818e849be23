"""Text preprocessing shared by the Shakespeare loaders (port of
``fedml_tpu/data/text.py``; after
fedml_api/data_preprocessing/{shakespeare/language_utils.py,
fed_shakespeare/utils.py} — both use the TFF text-generation tutorial's
86-char vocabulary with pad/bos/eos/oov, VOCAB_SIZE 90)."""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np

CHAR_VOCAB = list(
    "dhlptx@DHLPTX $(,048cgkoswCGKOSW[_#'/37;?bfjnrvzBFJNRVZ\"&*.26:\naeimquyAEIMQUY]!%)-159\r"
)
PAD_ID = 0
_CHAR_TO_ID = {c: i + 1 for i, c in enumerate(CHAR_VOCAB)}
BOS_ID = len(CHAR_VOCAB) + 1
EOS_ID = len(CHAR_VOCAB) + 2
OOV_ID = len(CHAR_VOCAB) + 3
VOCAB_SIZE = len(CHAR_VOCAB) + 4  # 90

SEQUENCE_LENGTH = 80  # McMahan et al. AISTATS 2017


def char_to_id(c: str) -> int:
    return _CHAR_TO_ID.get(c, OOV_ID)


def chars_to_ids(s: str) -> List[int]:
    return [char_to_id(c) for c in s]


def preprocess_snippets(
    sentences: Iterable[str], max_seq_len: int = SEQUENCE_LENGTH
) -> np.ndarray:
    """TFF-style snippet → fixed windows of max_seq_len+1 token ids with
    bos/eos and pad to a multiple (ref fed_shakespeare/utils.py:28-46).
    Returns [N, max_seq_len+1] int32."""
    seqs: List[List[int]] = []
    for sen in sentences:
        tokens = [BOS_ID] + chars_to_ids(sen) + [EOS_ID]
        if len(tokens) % (max_seq_len + 1) != 0:
            tokens += [PAD_ID] * ((-len(tokens)) % (max_seq_len + 1))
        for i in range(0, len(tokens), max_seq_len + 1):
            seqs.append(tokens[i : i + max_seq_len + 1])
    if not seqs:
        return np.zeros((0, max_seq_len + 1), np.int32)
    return np.asarray(seqs, np.int32)


def split_xy(sequences: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[N, T+1] → (x [N, T], y [N, T]) next-char targets
    (ref fed_shakespeare/utils.py:49-53)."""
    return sequences[:, :-1], sequences[:, 1:]
