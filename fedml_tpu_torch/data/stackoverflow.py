"""StackOverflow loaders (port of ``fedml_tpu/data/stackoverflow.py``):
tag prediction (logistic regression, multi-label) and next-word prediction,
from the TFF h5 files (group ``examples``/{client id} with ``tokens``,
``title`` and ``tags``) and the ``stackoverflow.word_count`` /
``stackoverflow.tag_count`` vocabulary files beside them.

- **lr**: the input is the mean bag-of-words of tokens + title over the
  top-10k words, the target multi-hot over the top-500 tags → task
  ``tag`` (a sigmoid BCE per tag).
- **nwp**: token ids over the top-10k words with pad 0, bos, eos and a
  hash-bucket OOV id, windows of 20 with next-word targets → task ``nwp``.

The whole dataset is 342k clients; ``max_clients`` bounds host RAM (the
disk store, data/mmap_store.py, holds populations beyond it). ``h5py`` is
imported when a loader runs, never when this module is imported."""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from fedml_tpu_torch.data.base import FederatedDataset

WORD_COUNT_FILE = "stackoverflow.word_count"
TAG_COUNT_FILE = "stackoverflow.tag_count"
TRAIN_FILE = "stackoverflow_train.h5"
TEST_FILE = "stackoverflow_test.h5"
_EXAMPLE = "examples"


def _require(path: str):
    if not os.path.exists(path):
        raise FileNotFoundError(f"stackoverflow file not found: {path}")
    return path


def _h5py():
    """h5py, imported when a loader opens its files (never at import)."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "the StackOverflow loaders read TFF h5 files, which needs the h5py package; "
            "it is not installed"
        ) from e
    return h5py


def load_word_vocab(data_dir: str, vocab_size: int = 10000) -> dict:
    """Top-N words from the word_count file (one 'word count' line each,
    ref stackoverflow_lr/utils.py:35-55)."""
    with open(_require(os.path.join(data_dir, WORD_COUNT_FILE))) as f:
        words = [next(f).split()[0] for _ in range(vocab_size)]
    return {w: i for i, w in enumerate(words)}


def load_tag_vocab(data_dir: str, tag_size: int = 500) -> dict:
    """Top-N tags from the tag_count JSON (ref utils.py:42-45)."""
    with open(_require(os.path.join(data_dir, TAG_COUNT_FILE))) as f:
        tags = json.load(f)
    return {t: i for i, t in enumerate(list(tags.keys())[:tag_size])}


def _decode(arr) -> List[str]:
    return [s.decode("utf-8") if isinstance(s, bytes) else str(s) for s in arr]


def _bag_of_words(sentences: List[str], word_dict: dict) -> np.ndarray:
    V = len(word_dict)
    out = np.zeros((len(sentences), V), np.float32)
    for i, s in enumerate(sentences):
        toks = s.split(" ")
        hits = [word_dict[t] for t in toks if t in word_dict]
        if toks:
            for h in hits:
                out[i, h] += 1.0
            out[i] /= len(toks)  # mean over tokens incl. OOV (ref :78-83)
    return out


def _multi_hot_tags(tag_strs: List[str], tag_dict: dict) -> np.ndarray:
    T = len(tag_dict)
    out = np.zeros((len(tag_strs), T), np.float32)
    for i, ts in enumerate(tag_strs):
        for t in ts.split("|"):
            if t in tag_dict:
                out[i, tag_dict[t]] = 1.0
    return out


def _to_ids(sentence: str, word_dict: dict, max_seq_len: int = 20, oov_buckets: int = 1):
    """pad=0, vocab ids shifted +1, bos/eos, hash OOV (ref nwp/utils.py)."""
    V = len(word_dict)
    bos, eos = V + 1, V + 2

    def wid(w):
        return word_dict[w] + 1 if w in word_dict else V + 3 + (hash(w) % oov_buckets)

    toks = [bos] + [wid(w) for w in sentence.split(" ")[:max_seq_len]] + [eos]
    toks = toks[: max_seq_len + 1]
    toks += [0] * (max_seq_len + 1 - len(toks))
    return toks


def load_stackoverflow_lr(
    data_dir: str, max_clients: Optional[int] = 1000, vocab_size: int = 10000, tag_size: int = 500
) -> FederatedDataset:
    h5py = _h5py()

    word_dict = load_word_vocab(data_dir, vocab_size)
    tag_dict = load_tag_vocab(data_dir, tag_size)

    def prep(g):
        sents = [
            f"{t} {ti}".strip()
            for t, ti in zip(_decode(g["tokens"]), _decode(g["title"]))
        ]
        return _bag_of_words(sents, word_dict), _multi_hot_tags(
            _decode(g["tags"]), tag_dict
        )

    with h5py.File(_require(os.path.join(data_dir, TRAIN_FILE)), "r") as tr, h5py.File(
        _require(os.path.join(data_dir, TEST_FILE)), "r"
    ) as te:
        ids = sorted(tr[_EXAMPLE].keys())
        if max_clients:
            ids = ids[:max_clients]
        client_x, client_y = [], []
        for cid in ids:
            x, y = prep(tr[_EXAMPLE][cid])
            client_x.append(x)
            client_y.append(y)
        t_ids = sorted(te[_EXAMPLE].keys())[: max_clients or None]
        txs, tys = zip(*(prep(te[_EXAMPLE][c]) for c in t_ids))
    return FederatedDataset(
        name="stackoverflow_lr",
        client_x=client_x,
        client_y=client_y,
        test_x=np.concatenate(txs),
        test_y=np.concatenate(tys),
        num_classes=tag_size,
    )


def load_stackoverflow_nwp(
    data_dir: str, max_clients: Optional[int] = 1000, vocab_size: int = 10000, max_seq_len: int = 20
) -> FederatedDataset:
    h5py = _h5py()

    word_dict = load_word_vocab(data_dir, vocab_size)

    def prep(g):
        seqs = np.asarray(
            [_to_ids(s, word_dict, max_seq_len) for s in _decode(g["tokens"])],
            np.int32,
        )
        if not len(seqs):
            seqs = np.zeros((0, max_seq_len + 1), np.int32)
        return seqs[:, :-1], seqs[:, 1:]

    with h5py.File(_require(os.path.join(data_dir, TRAIN_FILE)), "r") as tr, h5py.File(
        _require(os.path.join(data_dir, TEST_FILE)), "r"
    ) as te:
        ids = sorted(tr[_EXAMPLE].keys())
        if max_clients:
            ids = ids[:max_clients]
        client_x, client_y = [], []
        for cid in ids:
            x, y = prep(tr[_EXAMPLE][cid])
            client_x.append(x)
            client_y.append(y)
        t_ids = sorted(te[_EXAMPLE].keys())[: max_clients or None]
        txs, tys = zip(*(prep(te[_EXAMPLE][c]) for c in t_ids))
    return FederatedDataset(
        name="stackoverflow_nwp",
        client_x=client_x,
        client_y=client_y,
        test_x=np.concatenate([t for t in txs if len(t)]),
        test_y=np.concatenate([t for t in tys if len(t)]),
        num_classes=vocab_size + 4,
    )
