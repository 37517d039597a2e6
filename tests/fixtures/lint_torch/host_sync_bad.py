"""Fixture: host syncs inside the device loops (10 findings)."""
import torch
from torch.cuda import synchronize


def _latch(x, done):
    n = int(done)                           # reads a tensor on the host
    return x.item() + n                     # sync


class _StepGraph:
    def __init__(self, forward):
        self.forward = forward

    def run(self, st, K):
        out = []
        for _ in range(K):
            logits = self.forward(st)
            out.append(_latch(logits, st["done"]))
        return out


class Backend:
    def _iteration(self, st):
        host = st["tokens"].cpu().numpy()   # two: .cpu() and .numpy()
        torch.cuda.synchronize()            # blocks the host
        return st["logits"].to("cpu"), host

    def _verify_forward(self, x):
        synchronize()                       # torch.cuda.synchronize
        return (x.tolist(), x.to(torch.device("cpu")), float(x[0]))

    def fused_decode(self, st, K):
        # the host wrapper: outside the hot set, free to sync
        out = _StepGraph(self._iteration).run(st, K)
        return torch.stack(out).cpu().numpy()
