"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips without a CUDA device. This file imports no
JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from densefusion_tpu_torch.ops import knn


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,nq,nr,active", [
    (64, 500, 500, None),           # the serving path's scoring shape
    (3, 1003, 2600, [1, 0, 1]),     # ragged, > one ref tile, a gated row
])
def test_remap_kernel_matches_plain(b, nq, nr, active):
    dev = _cuda()
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((b, nq, 3))
                         .astype(np.float32)).to(dev)
    r = torch.from_numpy(rng.standard_normal((b, nr, 3))
                         .astype(np.float32)).to(dev)
    a = None if active is None else torch.tensor(active, dtype=torch.int32,
                                                 device=dev)
    kc, ks = knn.adds_remap_kernel(q, r, a)
    pc, ps = knn.adds_remap_plain(q, r, a)
    torch.cuda.synchronize()
    # the kernel rounds every score as the plain version does: exact match
    assert torch.equal(kc, pc)
    assert torch.equal(ks, ps)


@pytest.mark.cuda
def test_remap_kernel_ties_pick_lowest_index():
    dev = _cuda()
    rng = np.random.default_rng(1)
    half = rng.standard_normal((4, 300, 3)).astype(np.float32)
    r = torch.from_numpy(np.concatenate([half, half], 1)).to(dev)
    q = torch.from_numpy(rng.standard_normal((4, 700, 3))
                         .astype(np.float32)).to(dev)
    kc, _ = knn.adds_remap_kernel(q, r)
    _, idx = knn.nearest_neighbor(q, r)
    torch.cuda.synchronize()
    assert int(idx.max()) < 300
    assert torch.equal(kc, torch.gather(r, 1, idx[..., None].expand(-1, -1,
                                                                     3)))
