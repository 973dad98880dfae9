"""The window's start from the seed: a start state (u, v) on the node lattice
and a start time within the first source period.

The state is a sum of wave packets drawn from a ``torch.Generator`` on the
run's device: each packet a product of three 1D factors over the lattice's
nodes (a Gaussian envelope along each axis, the axial one carrying a
carrier of wavenumber k0 times a factor drawn from ``k_over_k0``), added in
place, so the state is made in a few large calls on the device. Every seed
gives the same sizes and the same work; only the packets differ.
"""

from __future__ import annotations

import math

import torch


def start_state(config: dict, traffic: dict, gdims, device, dtype, seed: int):
    """(u, v, t0) of the window's start for ``seed``: lattice vectors of
    ``dtype`` on ``device`` (flat, [prod(gdims)]) and the start time."""
    st = traffic["start"]
    f0 = config["f0"]
    L, W = config["domain"]["L"], config["domain"]["W"]
    c0 = config["medium"]["c0"] if "medium" in config else config["s0"]
    k0 = 2 * math.pi * f0 / c0
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    n = st["packets"]
    r = torch.rand((2, n, 8), generator=g, device=device, dtype=torch.float64)  # the 8th is spare
    t0 = float(torch.rand((), generator=g, device=device, dtype=torch.float64)) / f0
    axes = [torch.linspace(0.0, L, gdims[0], device=device, dtype=torch.float64),
            torch.linspace(-W / 2, W / 2, gdims[1], device=device, dtype=torch.float64),
            torch.linspace(-W / 2, W / 2, gdims[2], device=device, dtype=torch.float64)]
    lo_w, hi_w = st["width_m"]
    lo_k, hi_k = st["k_over_k0"]
    fields = []
    for f, scale in enumerate((st["amplitude_pa"], st["amplitude_pa"] * 2 * math.pi * f0)):
        out = torch.zeros(tuple(gdims), device=device, dtype=dtype)
        for j in range(n):
            p = r[f, j]
            centre = [p[0] * L, (p[1] - 0.5) * W, (p[2] - 0.5) * W]
            w = lo_w + (hi_w - lo_w) * p[3]
            k = k0 * (lo_k + (hi_k - lo_k) * p[4])
            amp = scale * (2 * p[5] - 1)
            env = [torch.exp(-0.5 * ((x - c) / w) ** 2) for x, c in zip(axes, centre)]
            gx = amp * env[0] * torch.cos(k * axes[0] + 2 * math.pi * p[6])
            gyz = env[1][:, None] * env[2][None, :]
            out.addcmul_(gx.to(dtype).view(-1, 1, 1), gyz.to(dtype).unsqueeze(0))
        fields.append(out.reshape(-1))
    return fields[0], fields[1], t0
