"""Synthetic federated datasets (port of ``fedml_tpu/data/synthetic.py``;
only ``synthetic_shakespeare`` so far).

A copy of the reference's numpy generator: the same seed gives
byte-identical arrays (tests/test_torch_fed_transformer.py)."""

from __future__ import annotations

import numpy as np

from fedml_tpu_torch.data.base import FederatedDataset


def synthetic_shakespeare(
    num_clients: int = 64,
    samples_per_client: int = 60,
    seq_len: int = 80,
    vocab_size: int = 90,
    seed: int = 0,
    seq_targets: bool = False,
) -> FederatedDataset:
    """Shakespeare-geometry next-char data (80-char windows over a 90-char
    vocab by default) from a synthetic Markov character process: char c
    goes to (c*7+3) mod V with probability 0.85, else to a uniform char.
    Each client's chain starts from a client-specific state; shard sizes
    are ragged (uniform 50-100% of ``samples_per_client``, at least 4).
    ``seq_targets`` gives causal-LM labels (every position's next char, task
    "nwp") instead of the window's single next char."""
    rng = np.random.default_rng(seed)
    succ = (np.arange(vocab_size) * 7 + 3) % vocab_size

    def chain(n_chars: int, state: int) -> np.ndarray:
        jump = rng.random(n_chars) < 0.85
        noise = rng.integers(0, vocab_size, n_chars)
        out = np.empty(n_chars, np.int32)
        for t in range(n_chars):
            state = succ[state] if jump[t] else noise[t]
            out[t] = state
        return out

    def windows(n: int, state: int):
        text = chain(n + seq_len, state)
        x = np.stack([text[i : i + seq_len] for i in range(n)]).astype(np.int32)
        if seq_targets:
            y = np.stack([text[i + 1 : i + 1 + seq_len] for i in range(n)]).astype(np.int32)
        else:
            y = text[seq_len : seq_len + n].astype(np.int32)
        return x, y

    client_x, client_y = [], []
    for _ in range(num_clients):
        n = max(4, int(samples_per_client * rng.uniform(0.5, 1.0)))
        x, y = windows(n, int(rng.integers(0, vocab_size)))
        client_x.append(x)
        client_y.append(y)
    xt, yt = windows(256, 1)
    return FederatedDataset(
        name="shakespeare_synth_lm" if seq_targets else "shakespeare_synth",
        client_x=client_x,
        client_y=client_y,
        test_x=xt,
        test_y=yt,
        num_classes=vocab_size,
    )
