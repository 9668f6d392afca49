"""Plain reference of the first steps of training, in float32.

What a step does (the configuration's training recipe): the raw 64x64
tiles of the batch (the synthetic EuroSAT tiles, regenerated here from
their seed), the tile preprocessing to model range at 192, the sensor
corruption with the counter-based Philox draws that the seed keys, the
train-mode forward (batch statistics), the loss ``mse + w * (1 - SSIM)``,
the backward, the global-norm clip over every gradient (the frozen
blocks' too), and AdamW on two groups, the encoder at a tenth of the
rate, with the frozen blocks and the fill's Gram matrix left out; the
rate is the warm-restart cosine at the update count.

``follow`` returns each step's loss, the clipped first gradient and the
change of each parameter after the steps.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.scene import preprocess

TILE = 64
CLAMP = 3.0
SSIM_WINDOW, SSIM_SIGMA, SSIM_RANGE = 11, 1.5, 6.0
ADAM_EPS = 1e-8


# --- the synthetic tiles and their order ---------------------------------

def split(n: int, train_split: float, seed: int) -> np.ndarray:
    state = np.random.get_state()
    np.random.seed(seed)
    order = np.random.permutation(n)
    np.random.set_state(state)
    return order[:int(train_split * n)]


def _smooth(rng, t: int, cell: int) -> np.ndarray:
    coarse = rng.normal(size=(max(t // cell, 1), max(t // cell, 1)))
    field = np.kron(coarse, np.ones((cell, cell)))[:t, :t]
    for axis in (0, 1):
        field = (np.roll(field, 1, axis) + field + np.roll(field, -1, axis)) / 3.0
    return (field - field.min()) / (np.ptp(field) + 1e-9)


def tile(seed: int, index: int, bands: int) -> np.ndarray:
    """The ``base`` synthetic tile ``index`` of a set seeded ``seed``: a
    smooth field with a gain and texture per band, in DN."""
    rng = np.random.default_rng(seed * 1_000_003 + index)
    base = _smooth(rng, TILE, 8)
    out = []
    for b in range(bands):
        gain = 0.6 + 0.4 * np.sin(0.5 * b + rng.uniform(0, 0.3))
        texture = rng.normal(scale=0.03, size=(TILE, TILE))
        out.append(np.clip(base * gain + texture + 0.1, 0, 1))
    return (np.stack(out, axis=-1) * 10000.0).astype(np.float32)


def batch_tiles(config: dict, step: int, batch: int) -> np.ndarray:
    """Batch ``step`` of the first epoch: the seeded order of the train
    split, ``batch`` tiles at a time."""
    data = config["data"]
    seed = int(config["seed"])
    train = split(int(data.get("synthetic_samples", 512)), float(data["train_split"]), seed)
    order = np.random.default_rng(seed * 100_003).permutation(len(train))
    picks = order[step * batch:(step + 1) * batch]
    return np.stack([tile(seed, int(train[i]), int(data["num_bands"])) for i in picks])


# --- seeds and the corruption ---------------------------------------------

def fold_in(seed: int, value: int) -> int:
    words = np.random.SeedSequence([int(seed), int(value)]).generate_state(2, np.uint32)
    return int(words[0]) | (int(words[1]) << 32)


M0, M1, W0, W1, MASK = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85, 0xFFFFFFFF


def _mulhilo(m: int, c: torch.Tensor):
    lo16 = (c & 0xFFFF) * m
    hi16 = (c >> 16) * m
    s = lo16 + ((hi16 & 0xFFFF) << 16)
    return (hi16 >> 16) + (s >> 32), s & MASK


def philox(counters, seed: int) -> list:
    """Philox4x32-10 of the counter words under the 64-bit ``seed``."""
    k0, k1 = seed & MASK, (seed >> 32) & MASK
    c = [torch.as_tensor(v, dtype=torch.int64) for v in counters]
    device = next((v.device for v in c if v.dim() > 0), c[0].device)
    c = [v.to(device) for v in c]
    for r in range(10):
        if r:
            k0, k1 = (k0 + W0) & MASK, (k1 + W1) & MASK
        hi0, lo0 = _mulhilo(M0, c[0])
        hi1, lo1 = _mulhilo(M1, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def _uniform(words):
    return ((words >> 9).to(torch.float32) + 0.5) * 2.0 ** -23


def _normals(a, b):
    r = torch.sqrt(-2.0 * torch.log(_uniform(a).double()))
    angle = math.pi * (2.0 * _uniform(b).double())
    return (r * torch.cos(angle)).float(), (r * torch.sin(angle)).float()


def corrupt(x: torch.Tensor, seed: int, noise: dict) -> torch.Tensor:
    """Speckle, dead bands, one normal for Gaussian and thermal noise
    (variance ``thermal^2 w_c^2 + gaussian^2`` on live bands, ``w`` from 1
    to 2 across the bands), clamp; the draws keyed by (seed, sample,
    position). Striping is off in the configurations here."""
    if noise.get("enable_striping", False):
        raise ValueError("the reference corrupts without striping")
    b, h, w, c = x.shape
    n = h * w * c
    dead_p = float(noise["dead_band_prob"])
    speckle, gauss = float(noise["speckle_sigma"]), float(noise["gaussian_sigma"])
    thermal = float(noise.get("thermal_noise_scale", noise.get("thermal_scale")))
    rows = torch.arange(b, device=x.device, dtype=torch.int64)[:, None]
    q = torch.arange((c + 4) // 4, device=x.device, dtype=torch.int64)[None, :]
    u = _uniform(torch.stack(philox([q, 0, rows, 0], seed), dim=-1).reshape(b, -1))
    alive = (u[:, :c] >= dead_p).float()[:, None, None, :]
    pairs = torch.arange((n + 1) // 2, device=x.device, dtype=torch.int64)[None, :]
    words = philox([pairs, 0, rows, 1], seed)
    even, odd = _normals(words[0], words[1]), _normals(words[2], words[3])
    n1 = torch.stack([even[0], odd[0]], dim=-1).reshape(b, -1)[:, :n].reshape(x.shape)
    n2 = torch.stack([even[1], odd[1]], dim=-1).reshape(b, -1)[:, :n].reshape(x.shape)
    weight = 1.0 + torch.arange(c, dtype=torch.float32, device=x.device) / max(c - 1, 1)
    y = x * (1.0 + n1 * speckle) * alive
    y = y + n2 * torch.sqrt(thermal ** 2 * weight * weight + gauss ** 2 * alive)
    return y.clamp(-CLAMP, CLAMP)


# --- the loss ---------------------------------------------------------------

def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of NHWC batches: 11x11 Gaussian (sigma 1.5) window, zero
    padding, constants from the data range 6."""
    g = np.exp(-(np.arange(SSIM_WINDOW) - SSIM_WINDOW // 2) ** 2 / (2 * SSIM_SIGMA ** 2))
    g = torch.tensor((g / g.sum()).astype(np.float32), device=x.device)
    x, y = x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2)
    c = x.shape[1]
    k = torch.outer(g, g)[None, None].expand(c, 1, SSIM_WINDOW, SSIM_WINDOW)

    def blur(t):
        return F.conv2d(t, k, padding=SSIM_WINDOW // 2, groups=c)

    c1, c2 = (0.01 * SSIM_RANGE) ** 2, (0.03 * SSIM_RANGE) ** 2
    mx, my = blur(x), blur(y)
    vx, vy, cxy = blur(x * x) - mx * mx, blur(y * y) - my * my, blur(x * y) - mx * my
    s = ((2 * mx * my + c1) * (2 * cxy + c2)) / ((mx * mx + my * my + c1) * (vx + vy + c2))
    return s.mean()


def loss_fn(out: torch.Tensor, clean: torch.Tensor, loss_cfg: dict) -> torch.Tensor:
    mse = torch.mean((out - clean) ** 2)
    return float(loss_cfg.get("mse_weight", 1.0)) * mse + \
        float(loss_cfg.get("ssim_weight", 0.1)) * (1.0 - ssim(out, clean))


# --- the optimizer ----------------------------------------------------------

def rate(training: dict, count: int) -> float:
    """Warm-restart cosine (SGDR) at ``count`` updates, in float32 as the
    recipe evaluates it; ``T_0`` in updates."""
    opt, sched = training["optimizer"], training["scheduler"]
    base, low = float(opt["lr"]), float(sched["eta_min"])
    t0, m = float(sched["T_0"]), float(sched["T_mult"])
    f32 = torch.float32
    t = torch.tensor(float(count), dtype=f32)
    if m == 1.0:
        frac = torch.remainder(t, t0) / t0
    else:
        k = torch.floor(torch.log(t / t0 * (m - 1.0) + 1.0) / math.log(m) + 1e-5)
        start = t0 * (torch.pow(torch.tensor(m, dtype=f32), k) - 1.0) / (m - 1.0)
        frac = torch.clamp((t - start) / (t0 * torch.pow(torch.tensor(m, dtype=f32), k)), 0, 1)
    return float(low + (base - low) * 0.5 * (1.0 + torch.cos(math.pi * frac)))


def group(name: str, frozen_blocks: set) -> str:
    parts = name.split(".")
    if parts[0] == "fill_gram":
        return "frozen"
    if parts[0] == "encoder":
        if len(parts) > 2 and parts[1] == "blocks" and int(parts[2]) in frozen_blocks:
            return "frozen"
        return "encoder"
    return "decoder"


def follow(model, config: dict, steps: int, batch: int, seed: int):
    """Train ``model`` (the reference, float32, train mode) for ``steps``
    from the configuration's first batches. Returns ``(losses, first
    clipped gradient by name, change by name, first unclipped gradient by
    name)``."""
    training = config["training"]
    opt = training["optimizer"]
    beta1, beta2 = (float(b) for b in opt["betas"])
    decay, scale = float(opt["weight_decay"]), float(opt["encoder_lr_scale"])
    clip = float(training["gradient_clip"])
    frozen = {int(i) for i in config["model"]["encoder"].get("freeze_layers") or ()}
    params = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    moments = {n: (torch.zeros_like(p), torch.zeros_like(p)) for n, p in params.items()}
    device = next(model.parameters()).device
    size = int(config["data"]["image_size"])
    losses, first, first_raw = [], {}, {}
    for step in range(steps):
        raw = torch.from_numpy(batch_tiles(config, step, batch)).to(device)
        clean = preprocess(raw, size)
        noisy = corrupt(clean, fold_in(fold_in(seed, 0), step), config["noise"])
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model(noisy), clean, training["loss"])
        loss.backward()
        losses.append(float(loss.detach()))
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in params.items()}
        norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads.values())).float()
        factor = clip / norm if norm >= clip else torch.ones((), device=device)
        lr = rate(training, step)
        with torch.no_grad():
            for n, p in params.items():
                kind = group(n, frozen)
                g = grads[n] * factor
                if step == 0:
                    first[n], first_raw[n] = g.clone(), grads[n].clone()
                if kind == "frozen":
                    continue
                m, v = moments[n]
                m.mul_(beta1).add_(g, alpha=1 - beta1)
                v.mul_(beta2).addcmul_(g, g, value=1 - beta2)
                step_lr = lr * (scale if kind == "encoder" else 1.0)
                p.mul_(1 - step_lr * decay)
                denom = (v / (1 - beta2 ** (step + 1))).sqrt() + ADAM_EPS
                p.addcdiv_(m, denom, value=-step_lr / (1 - beta1 ** (step + 1)))
    change = {n: params[n].detach() - start[n] for n in params}
    return losses, first, change, first_raw
