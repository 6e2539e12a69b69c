"""LSTM language models (port of ``fedml_tpu.models.rnn``):

- ``RNNOriginalFedAvg``, the FedAvg paper's Shakespeare char-LM:
  Embed(90, 8) → 2 × LSTM(256) → Dense(90);
- ``RNNStackOverflow``, Stack Overflow next-word prediction:
  Embed(10004, 96) → LSTM(670) → Dense(96) → Dense(10004).

The reference cell is flax's ``OptimizedLSTMCell`` run by ``nn.RNN`` from
a zero carry: gates i, f, g, o with σ for i, f, o and tanh for g,
``c' = f·c + i·g`` and ``h' = o·tanh(c')``.  Its input kernels
``ii/if/ig/io`` (E, H) have no bias (lecun-normal), its hidden kernels
``hi/hf/hg/ho`` (H, H) a bias (orthogonal, zero bias).

The cell here is plain tensor ops over a Python loop over time, not
``nn.LSTM``: ``torch.func.vmap`` batches these ops over a cohort (no fused
RNN op has a batching rule), and a round's CUDA graph captures them.  The
input projection of every time step is one product before the loop; each
step then takes one product with the four hidden kernels side by side.
``if`` is a Python keyword, so the gate layers are ``in_i``…``hid_o`` here
and the cell's ``flax_names`` maps them to flax's names
(``_LSTMStack_0.lstm_0.in_f.weight`` ↔ ``_LSTMStack_0/lstm_0/if/kernel``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

GATES = ("i", "f", "g", "o")


class LSTMCell(nn.Module):
    """One LSTM layer over a whole sequence ``(B, T, E) → (B, T, H)``."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.features = features
        self.flax_names = {}
        for g in GATES:
            self.add_module(f"in_{g}", nn.Linear(in_features, features,
                                                 bias=False))
            hid = nn.Linear(features, features)
            hid.kernel_init = "orthogonal"
            self.add_module(f"hid_{g}", hid)
            self.flax_names.update({f"in_{g}": f"i{g}", f"hid_{g}": f"h{g}"})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H = self.features
        w_in = torch.cat([getattr(self, f"in_{g}").weight for g in GATES])
        w_hid = torch.cat([getattr(self, f"hid_{g}").weight for g in GATES])
        b_hid = torch.cat([getattr(self, f"hid_{g}").bias for g in GATES])
        xs = F.linear(x, w_in)          # every step's input projection
        h = c = x.new_zeros(x.shape[:-2] + (H,))
        outs = []
        for t in range(x.shape[-2]):
            z = F.linear(h, w_hid, b_hid) + xs[..., t, :]
            sig = torch.sigmoid(z)
            i, f, o = sig[..., :H], sig[..., H:2 * H], sig[..., 3 * H:]
            c = f * c + i * torch.tanh(z[..., 2 * H:3 * H])
            h = o * torch.tanh(c)
            outs.append(h)
        return torch.stack(outs, dim=-2)


class LSTMStack(nn.Module):
    def __init__(self, in_features: int, features: int, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"lstm_{i}", LSTMCell(
                in_features if i == 0 else features, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"lstm_{i}")(x)
        return x


class RNNOriginalFedAvg(nn.Module):
    def __init__(self, vocab_size: int = 90, embedding_dim: int = 8,
                 hidden_size: int = 256):
        super().__init__()
        self.Embed_0 = nn.Embedding(vocab_size, embedding_dim)
        self._LSTMStack_0 = LSTMStack(embedding_dim, hidden_size, 2)
        self.Dense_0 = nn.Linear(hidden_size, vocab_size)

    def forward(self, x: torch.Tensor, dropout_masks=None) -> torch.Tensor:
        return self.Dense_0(self._LSTMStack_0(self.Embed_0(x)))


class RNNStackOverflow(nn.Module):
    def __init__(self, vocab_size: int = 10004, embedding_dim: int = 96,
                 hidden_size: int = 670):
        super().__init__()
        self.Embed_0 = nn.Embedding(vocab_size, embedding_dim)
        self._LSTMStack_0 = LSTMStack(embedding_dim, hidden_size, 1)
        self.Dense_0 = nn.Linear(hidden_size, embedding_dim)
        self.Dense_1 = nn.Linear(embedding_dim, vocab_size)

    def forward(self, x: torch.Tensor, dropout_masks=None) -> torch.Tensor:
        h = self.Dense_0(self._LSTMStack_0(self.Embed_0(x)))
        return self.Dense_1(h)
