"""Federated NLP RNNs (port of ``fedml_tpu/models/rnn.py``).

- :class:`RNNOriginalFedAvg`: embed(90→8) → 2×LSTM(256) → dense(vocab).
  ``seq_output=False`` predicts from the last position (shakespeare
  next-char classification); ``True`` gives every position's logits
  (fed_shakespeare).
- :class:`RNNStackOverFlow`: the extended vocabulary (10000 + pad/bos/eos
  + 1 OOV bucket = 10004), embed 96 → LSTM(670) → dense 96 → dense
  10004, every position's logits.

**The LSTM's parameters are the reference's eight leaves a layer.** flax's
``OptimizedLSTMCell`` keeps input kernels ``ii``, ``if``, ``ig``, ``io``
[in, H] without biases and hidden kernels ``hi``, ``hf``, ``hg``, ``ho``
[H, H] with biases [H]; here each is a dense ``weight`` [H, in] (the
bridge's kernel transpose) under the same scope (``OptimizedLSTMCell_0``,
the name flax gives the cell). The forward concatenates them, gates in the
order i, f, g, o of both packages, into ``torch.lstm``'s layout and runs
the recurrence there (cuDNN on the card), with a zero input bias that
carries no gradient, from a zero carry. So checkpoints, wire leaves and
the stateful algorithms' state rows keep the reference's leaf count and
order, and nothing but the hidden biases can train a bias. Padding token
0 is handled in the loss (``masked_seq_ce``), not the embedding."""

from __future__ import annotations

import torch
from torch import nn

from fedml_tpu_torch.models.transformer import Embed

GATES = ("i", "f", "g", "o")


class _Dense(nn.Module):
    """flax's ``DenseParams``: a ``weight`` [out, in] and, with ``bias``, a
    ``bias`` [out]; the LSTM reads them, this module computes nothing."""

    def __init__(self, in_features: int, out_features: int, bias: bool, orthogonal: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        if bias:
            self.bias = nn.Parameter(torch.empty(out_features))
        else:
            self.register_parameter("bias", None)
        # flax's recurrent_kernel_init: orthogonal (models init_param_)
        self.orthogonal_init = ("weight",) if orthogonal else ()


class OptimizedLSTMCell(nn.Module):
    """One LSTM layer's parameters, named as flax's ``OptimizedLSTMCell``."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        for g in GATES:
            self.add_module(f"i{g}", _Dense(in_features, hidden, bias=False, orthogonal=False))
        for g in GATES:
            self.add_module(f"h{g}", _Dense(hidden, hidden, bias=True, orthogonal=True))

    def lstm_params(self):
        """[w_ih [4H, in], w_hh [4H, H], b_ih (zeros) [4H], b_hh [4H]]."""
        dense = dict(self.named_children())
        w_ih = torch.cat([dense[f"i{g}"].weight for g in GATES])
        w_hh = torch.cat([dense[f"h{g}"].weight for g in GATES])
        b_hh = torch.cat([dense[f"h{g}"].bias for g in GATES])
        return [w_ih, w_hh, torch.zeros_like(b_hh), b_hh]


def run_lstm(x: torch.Tensor, cells) -> torch.Tensor:
    """Stacked LSTM layers over x [B, T, in] from a zero carry → the last
    layer's outputs [B, T, H], in one ``torch.lstm`` call."""
    params = [p for cell in cells for p in cell.lstm_params()]
    H = cells[0].hidden
    zeros = x.new_zeros(len(cells), x.shape[0], H)
    # train: cuDNN keeps what the backward needs only when asked
    out, _, _ = torch.lstm(x, (zeros, zeros), params, True, len(cells), 0.0,
                           torch.is_grad_enabled(), False, True)
    return out


class RNNOriginalFedAvg(nn.Module):
    """tokens [B, T] int → logits [B, vocab] (``seq_output`` False) or
    [B, T, vocab]."""

    def __init__(self, vocab_size: int = 90, embedding_dim: int = 8, hidden_size: int = 256,
                 seq_output: bool = False):
        super().__init__()
        self.vocab_size, self.seq_output = vocab_size, seq_output
        self.embeddings = Embed(vocab_size, embedding_dim)
        self.OptimizedLSTMCell_0 = OptimizedLSTMCell(embedding_dim, hidden_size)
        self.OptimizedLSTMCell_1 = OptimizedLSTMCell(hidden_size, hidden_size)
        self.fc = nn.Linear(hidden_size, vocab_size)

    def forward(self, tokens):
        h = run_lstm(self.embeddings(tokens), [self.OptimizedLSTMCell_0, self.OptimizedLSTMCell_1])
        if not self.seq_output:
            h = h[:, -1]
        return self.fc(h)


class RNNStackOverFlow(nn.Module):
    """tokens [B, T] int → logits [B, T, vocab_size + 3 + num_oov_buckets]."""

    def __init__(self, vocab_size: int = 10000, num_oov_buckets: int = 1,
                 embedding_size: int = 96, latent_size: int = 670):
        super().__init__()
        self.vocab_size, self.num_oov_buckets = vocab_size, num_oov_buckets
        extended = vocab_size + 3 + num_oov_buckets
        self.word_embeddings = Embed(extended, embedding_size)
        self.OptimizedLSTMCell_0 = OptimizedLSTMCell(embedding_size, latent_size)
        self.fc1 = nn.Linear(latent_size, embedding_size)
        self.fc2 = nn.Linear(embedding_size, extended)

    def forward(self, tokens):
        h = run_lstm(self.word_embeddings(tokens), [self.OptimizedLSTMCell_0])
        return self.fc2(self.fc1(h))
