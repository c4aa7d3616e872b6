"""Kernel K1 on the card against its plain version.

Marked ``cuda``: it skips without a CUDA device (a CUDA kernel has no CPU
mode). This file imports neither JAX nor the JAX package, so it also runs on
a machine without them: ``python -m pytest --noconftest tests/test_torch_cuda.py``.
"""

import pytest
import torch

from p2pmicrogrid_tpu_torch.ops.merged_min import merged_min_sums, merged_min_sums_plain


@pytest.fixture
def cuda_generator():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 1000), (256, 50), (3, 7)])
def test_merged_min_kernel_matches_plain(cuda_generator, shape):
    """At the main path's shapes and a ragged small one; zero factors give
    exactly 0, and a repeat launch is bit-identical."""
    S, A = shape
    rand = lambda: torch.rand((S, A), generator=cuda_generator, device="cuda")
    args = [rand() for _ in range(4)] + [(rand() > 0.5).float() for _ in range(2)]
    args[0][0] = 0.0
    args[3][0] = 0.0
    before = merged_min_sums.launches
    row, col = merged_min_sums(*args)
    row2, col2 = merged_min_sums(*args)
    torch.cuda.synchronize()
    assert merged_min_sums.launches == before + 2
    for got, ref in zip((row, col), merged_min_sums_plain(*args)):
        scale = float(ref.abs().max())
        # Sums of up to A positive terms in another order than torch.sum's.
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6 * scale)
    assert float(row[0].abs().max()) == 0.0  # alpha = gamma = 0 in scenario 0
    assert torch.equal(row, row2) and torch.equal(col, col2)


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(cuda_generator):
    x = torch.rand((4, 8), generator=cuda_generator, device="cuda")
    good = [x] * 6
    with pytest.raises(ValueError, match="float32"):
        merged_min_sums(*good[:5], x.double())
    with pytest.raises(ValueError, match="shape"):
        merged_min_sums(*good[:5], x[:, :4].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        merged_min_sums(*good[:5], x.t().contiguous().t())
