"""Test-time self-ensemble over the dihedral group (D4), in PyTorch.

Counterpart of ``msid_tpu/ops/tta.py``: average the restorer's output over
rotated and flipped views of the noisy input, inverting each transform
before averaging. The orbit's order is the JAX package's, so every prefix
is the same set of views, and its first four elements keep non-square
shapes:

  1: identity            2: +hflip        3: +vflip      4: +rot180
  5: +rot90              6: +rot90 hflip  7: +rot270     8: +rot270 hflip

Tensors are NHWC; ``torch.rot90(dims=(1, 2))`` is ``jnp.rot90(axes=(1, 2))``.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

# (rot90 quarter-turns, flip of the W axis) per orbit element.
DIHEDRAL_ORBIT: Tuple[Tuple[int, bool], ...] = (
    (0, False),  # identity
    (0, True),   # horizontal flip
    (2, True),   # vertical flip (rot180 . hflip)
    (2, False),  # rot180
    (1, False),
    (1, True),
    (3, False),
    (3, True),
)


def dihedral_transform(x: torch.Tensor, k: int, flip: bool) -> torch.Tensor:
    """rot90^k, then an optional W-axis flip, of an NHWC batch."""
    if k:
        x = torch.rot90(x, k, dims=(1, 2))
    if flip:
        x = x.flip(2)
    return x


def dihedral_inverse(y: torch.Tensor, k: int, flip: bool) -> torch.Tensor:
    """Invert :func:`dihedral_transform` with the same ``(k, flip)``."""
    if flip:
        y = y.flip(2)
    if k:
        y = torch.rot90(y, -k, dims=(1, 2))
    return y


def orbit_prefix(num_transforms: int, height: int, width: int
                 ) -> Sequence[Tuple[int, bool]]:
    """The first ``num_transforms`` orbit elements, validated for shape."""
    if not 1 <= num_transforms <= len(DIHEDRAL_ORBIT):
        raise ValueError(
            f"num_transforms must be in [1, {len(DIHEDRAL_ORBIT)}], "
            f"got {num_transforms}")
    if height != width and num_transforms > 4:
        raise ValueError(
            f"90-degree rotations need square tiles; got {height}x{width} "
            f"with num_transforms={num_transforms} (max 4 for non-square)")
    return DIHEDRAL_ORBIT[:num_transforms]


def dihedral_ensemble(forward: Callable[[torch.Tensor], torch.Tensor],
                      x: torch.Tensor, num_transforms: int = 8) -> torch.Tensor:
    """Average ``forward`` over the first ``num_transforms`` dihedral views
    of the NHWC batch ``x``, accumulating in fp32 whatever the forward's
    dtype. One view returns ``forward(x)`` as it is."""
    orbit = orbit_prefix(num_transforms, x.shape[1], x.shape[2])
    if len(orbit) == 1:
        return forward(x)
    acc = None
    for k, flip in orbit:
        y = dihedral_inverse(forward(dihedral_transform(x, k, flip)).float(), k, flip)
        acc = y if acc is None else acc + y
    return acc / float(len(orbit))


def wrap_forward(forward: Callable[[torch.Tensor], torch.Tensor], num_transforms: int,
                 height: int, width: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """Wrap ``forward`` in the dihedral self-ensemble. The orbit is checked
    against the spatial shape here, so a caller fails when it is built;
    one view returns ``forward`` itself."""
    orbit_prefix(num_transforms, height, width)
    if num_transforms == 1:
        return forward

    def ensembled(x: torch.Tensor) -> torch.Tensor:
        return dihedral_ensemble(forward, x, num_transforms)

    return ensembled
