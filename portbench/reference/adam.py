"""Adam (Kingma and Ba), plain, with bias correction; a leaf without a
gradient is left alone and gets no state."""

from __future__ import annotations

import torch


class Adam:
    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.params = params  # name -> leaf tensor
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.state = {}

    @torch.no_grad()
    def step(self) -> None:
        for name, p in self.params.items():
            if p.grad is None:
                continue
            st = self.state.setdefault(name, {
                "t": 0, "m": torch.zeros_like(p), "v": torch.zeros_like(p)})
            st["t"] += 1
            g = p.grad
            st["m"].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            st["v"].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            m_hat = st["m"] / (1.0 - self.b1 ** st["t"])
            v_hat = st["v"] / (1.0 - self.b2 ** st["t"])
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))
