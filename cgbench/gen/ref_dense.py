"""The reference's dense SPD system, drawn on the device from the seed.

``generateSPDmatrix.m``'s construction, A = (R + R^T) / 2 + n I with R
uniform on [0, 1), in float32, made with a ``torch.Generator`` on the device
in a few large calls (the program's ``generate_spd_system`` draws the same
construction from numpy on the host, a different stream).
"""

from __future__ import annotations

import torch


def dense_spd(n: int, generator: torch.Generator, device) -> torch.Tensor:
    R = torch.rand((n, n), generator=generator, device=device, dtype=torch.float32)
    A = R + R.T
    del R
    A.mul_(0.5)
    A.diagonal().add_(float(n))
    return A


def make(config: dict, seed: int, device):
    from cgbench.traffic import generator_for

    A = dense_spd(int(config["n"]), generator_for(seed, "matrix", device), device)
    return {"kind": "dense", "n": int(config["n"]), "A": A}
