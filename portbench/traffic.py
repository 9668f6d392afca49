"""The general generator: a traffic file's parameters and a seed in, the
cell's inputs out. Every seed gets the same sizes and the same multiset of
arrival gaps, in another order and with other contents, so that seeds
change what is computed and not how much.

* ``scenes``: ``count`` raw scenes ``[side, side, bands]`` of uint16
  Sentinel-2 DN: per band a level and a smooth field (bilinear from a
  coarse grid of ``cell`` pixels) plus fine texture, kept in [100, 4500];
  one band of each scene holds a dead rectangle (5000 DN and a hair of
  noise: the fill stage's dead-band path), its band, place and size drawn.
* ``tiles``: ``count`` model-range noisy tiles ``[1, size, size, bands]``
  float32 (normal(0, 0.5), 1-2 bands per tile killed to thermal noise),
  a serving client's requests.
* ``arrivals``: open-loop due times of ``rate`` requests per second over
  ``seconds``: exponential gaps at the stratified quantiles
  ``(i + 0.5) / n``, shuffled by the seed.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

DEAD_DN = 5000.0


def _generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) * 7919 + stream) % 2 ** 63)


def scenes(traffic: dict, seed: int, device: torch.device) -> list[np.ndarray]:
    side, bands, count = int(traffic["scene_side"]), int(traffic["bands"]), int(traffic["scenes"])
    cell = int(traffic.get("field_cell", 32))
    g = _generator(seed, 1, device)
    coarse = -(-side // cell) + 1
    out = []
    for _ in range(count):
        level = torch.rand(bands, 1, 1, generator=g, device=device) * 1700 + 800
        amp = torch.rand(bands, 1, 1, generator=g, device=device) * 600 + 200
        field = torch.randn(1, 1, coarse, coarse, generator=g, device=device)
        field = F.interpolate(field, size=(side, side), mode="bilinear", align_corners=False)[0]
        tex = torch.randn(bands, side, side, generator=g, device=device) * 30
        dn = (level + amp * field + tex).clamp(100, 4500)
        place = torch.rand(5, generator=g, device=device).tolist()
        band = int(place[0] * bands) % bands
        h = int(side * (0.15 + 0.35 * place[1]))
        w = int(side * (0.15 + 0.35 * place[2]))
        y, x = int((side - h) * place[3]), int((side - w) * place[4])
        dead = DEAD_DN + 2 * torch.randn(h, w, generator=g, device=device)
        dn[band, y:y + h, x:x + w] = dead
        out.append(dn.round().permute(1, 2, 0).to(torch.int32).cpu().numpy().astype(np.uint16))
    return out


def tiles(traffic: dict, seed: int, device: torch.device) -> list[np.ndarray]:
    size, bands, count = int(traffic["tile_size"]), int(traffic["bands"]), int(traffic["pool"])
    g = _generator(seed, 2, device)
    x = torch.randn(count, size, size, bands, generator=g, device=device) * 0.5
    kills = torch.rand(count, 3, generator=g, device=device).tolist()
    for i, (two, a, b) in enumerate(kills):
        for c in {int(a * bands) % bands, int(b * bands) % bands} if two < 0.5 else \
                {int(a * bands) % bands}:
            x[i, :, :, c] = torch.randn(size, size, generator=g, device=device) * 0.005
    host = x.cpu().numpy()
    return [host[i:i + 1].copy() for i in range(count)]


def arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    n = int(round(rate * seconds))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    np.random.default_rng([int(seed), 3]).shuffle(gaps)
    return np.cumsum(gaps) - gaps[0]
