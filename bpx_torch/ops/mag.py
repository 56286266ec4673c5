"""MAG, the Multimodal Adaptation Gate (counterpart: ``bpx/ops/mag.py``):
``mmtrvat``'s second choice of final fusion (``fusion="mag"``).

  w_v = relu(W_hv [visual; text]);  w_a = relu(W_ha [acoustic; text])
  h_m = w_v * (W_v visual) + w_a * (W_a acoustic)
  alpha = min(||text|| / (||h_m|| + 1e-6) * beta_shift, 1)   (||h_m|| = 0
          counts as 1)
  out   = dropout(LayerNorm(alpha * h_m + text))

The Dense layers have biases and compute in the module's dtype; the norms
and the gate are taken in that dtype too, as the JAX package does; the
LayerNorm is the port's (its CUDA kernel on the card); the dropout is the
hash dropout, in training mode only, with the next seed of the forward's
:class:`SeedStream`.  ``alpha`` is returned beside the output, as the
GMUs return their gates.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from bpx_torch.ops.dropout import SeedStream, maybe_dropout
from bpx_torch.ops.init import linear
from bpx_torch.ops.norm import LayerNorm


class MAG(nn.Module):
    def __init__(self, hidden_size: int, beta_shift: float = 1e-3,
                 dropout_prob: float = 0.5,
                 dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        E = hidden_size
        self.beta_shift = beta_shift
        self.dropout_prob = dropout_prob
        self.dtype = dtype
        self.W_hv = linear(2 * E, E, True, "lecun", gen, device)
        self.W_ha = linear(2 * E, E, True, "lecun", gen, device)
        self.W_v = linear(E, E, True, "lecun", gen, device)
        self.W_a = linear(E, E, True, "lecun", gen, device)
        self.norm = LayerNorm(E, dtype=dtype, device=device)

    def _dense(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return nn.functional.linear(x.to(dt), layer.weight.to(dt),
                                    layer.bias.to(dt))

    def forward(self, text: torch.Tensor, visual: torch.Tensor,
                acoustic: torch.Tensor,
                seeds: Optional[SeedStream] = None):
        """(fused, alpha) for (B, E) inputs; alpha is (B, 1)."""
        w_v = torch.relu(self._dense(self.W_hv, torch.cat([visual, text], -1)))
        w_a = torch.relu(self._dense(self.W_ha,
                                     torch.cat([acoustic, text], -1)))
        h_m = (w_v * self._dense(self.W_v, visual)
               + w_a * self._dense(self.W_a, acoustic))
        em_norm = torch.linalg.vector_norm(text, dim=-1)
        hm_norm = torch.linalg.vector_norm(h_m, dim=-1)
        hm_norm = torch.where(hm_norm == 0, torch.ones_like(hm_norm),
                              hm_norm)
        alpha = torch.clamp(em_norm / (hm_norm + 1e-6) * self.beta_shift,
                            max=1.0)
        out = self.norm(alpha[..., None] * h_m + text)
        out = maybe_dropout(out, self.dropout_prob, self.training, seeds)
        return out, alpha[..., None]
