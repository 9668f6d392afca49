"""The port's hand-written kernels on the card (tests marked ``cuda``).

These need an NVIDIA GPU and ``nvcc``: a CUDA kernel has no CPU mode. Each
test decides inside itself whether there is a card and skips without one.
The file imports only torch, numpy and the port, so on a machine with a
card and no JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from msid_tpu_torch.models.blocks import ResidualBlock
from msid_tpu_torch.ops import cuda_decoder
from msid_tpu_torch.ops.cuda_decoder import (
    fold_batchnorm,
    fused_residual_block,
    fused_residual_block_reference,
)

K4_MAX_ABS = 1e-4      # fp32 against fp32, sums in another order over K = 9C


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the kernels are CUDA C++ with no CPU mode")
    torch.backends.cudnn.allow_tf32 = False


def block_inputs(shape, seed):
    """fp32 x, w1, w2 (HWIO) and a folded [4, C] affine, on the card."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.normal(0, 1, shape).astype(np.float32)
    w1, w2 = (rng.normal(0, 1 / np.sqrt(9 * c), (3, 3, c, c)).astype(np.float32)
              for _ in range(2))
    folds = [fold_batchnorm(rng.normal(1, 0.1, c), rng.normal(0, 0.1, c),
                            rng.normal(0, 0.1, c), rng.uniform(0.5, 2, c)) for _ in range(2)]
    aff = np.stack([folds[0][0], folds[0][1], folds[1][0], folds[1][1]]).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (x, w1, w2, aff)]


@pytest.mark.cuda
@pytest.mark.parametrize("c,s", [(48, 32), (384, 24), (12, 20), (8, 64)])
def test_k4_matches_plain_on_the_card(c, s):
    need_card()
    args = block_inputs((2, s, s, c), seed=c)
    before = cuda_decoder.launches_fp32
    got = fused_residual_block(*args)
    want = fused_residual_block_reference(*args)
    torch.cuda.synchronize()
    assert cuda_decoder.launches_fp32 == before + 1
    assert float((got - want).abs().max()) <= K4_MAX_ABS


@pytest.mark.cuda
def test_fp32_eval_block_launches_k4_on_the_card():
    need_card()
    torch.manual_seed(0)
    block = ResidualBlock(24).eval()
    x = torch.randn(2, 24, 16, 16)
    with torch.no_grad():
        want = block(x)                            # the plain version on the CPU
        block.cuda()
        before = cuda_decoder.launches, cuda_decoder.launches_fp32
        got = block(x.cuda()).cpu()
    assert (cuda_decoder.launches, cuda_decoder.launches_fp32) == (before[0], before[1] + 1)
    assert float((got - want).abs().max()) <= K4_MAX_ABS
