"""The control: the plain reference in the program's place, in the precision
below the configuration's, which every cell's comparison has to reject."""

from __future__ import annotations

from torch import nn

from torch_bench.reference import models
from torch_bench.reference.steps import nchw, precision


class _Tap(nn.Module):
    """Stands where the program's dec2 stage is, so a hook there sees
    dec2's (features, mask), NHWC."""

    def forward(self, h, m):
        return h, m


class ReferenceGenerator(nn.Module):
    """The reference's eval forward behind the program's generator
    interface: NHWC ``x`` (already masked) and ``mask`` -> the composite."""

    def __init__(self, state, precision_name: str):
        super().__init__()
        self.params = {k: v.detach().clone() for k, v in state.items()}
        self.precision = precision_name
        self.dec2 = _Tap()
        self.training = False

    def forward(self, x, mask):
        taps = {}
        with precision(self.precision, x.device):
            out = models.generator(self.params, nchw(x), nchw(mask), train=False, taps=taps)
        self.dec2(taps["dec2"].permute(0, 2, 3, 1), None)
        return out.permute(0, 2, 3, 1)


def reference_program(state, name: str) -> ReferenceGenerator:
    if name != "tf32":
        raise ValueError(f"unknown control {name!r}")
    return ReferenceGenerator(state, name)
