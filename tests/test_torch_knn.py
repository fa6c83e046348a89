"""Port parity: the ADD-S remap's plain version against the JAX package's
Pallas kernel ``_remap_kernel_bt`` (run in TPU interpret mode, as
``tests/test_knn.py`` runs it) and against its XLA gather path.

Tolerances: coordinates are compared EXACTLY (the winning ref's own
coordinates are copied, so any argmin disagreement shows); scores to
rtol/atol 1e-5, since the Pallas kernel forms q.r by a matmul and the port
by three rounded products.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from densefusion_tpu.ops import adds_remap_targets as j_remap_targets
from densefusion_tpu.ops.knn import (
    adds_remap_pallas_batched, nearest_neighbor_xla,
)
from densefusion_tpu_torch.ops import knn

from tests.torch_port_util import to_np


def _pallas(q, r, active=None):
    with jax.disable_jit(), pltpu.force_tpu_interpret_mode():
        c, s = adds_remap_pallas_batched(
            jnp.asarray(q), jnp.asarray(r),
            None if active is None else jnp.asarray(active))
    return np.asarray(c), np.asarray(s)


def _plain(q, r, active=None):
    c, s = knn.adds_remap_plain(torch.from_numpy(q), torch.from_numpy(r),
                                None if active is None
                                else torch.from_numpy(active))
    return to_np(c), to_np(s)


@pytest.mark.parametrize("b,nq,nr", [
    (2, 300, 200),      # one tile each way
    (3, 37, 613),       # ragged Q and R, R past one Pallas ref tile
])
def test_remap_matches_pallas_and_xla(rng, b, nq, nr):
    q = rng.standard_normal((b, nq, 3)).astype(np.float32)
    r = rng.standard_normal((b, nr, 3)).astype(np.float32)
    got_c, got_s = _plain(q, r)
    want_c, want_s = _pallas(q, r)
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-5)
    xla = np.asarray(j_remap_targets(jnp.asarray(q), jnp.asarray(r),
                                     backend="xla"))
    np.testing.assert_array_equal(got_c, xla)
    # the public entry on CPU tensors is the plain version
    np.testing.assert_array_equal(
        to_np(knn.adds_remap_targets(torch.from_numpy(q),
                                     torch.from_numpy(r))), got_c)


def test_remap_ties_pick_lowest_index(rng):
    """Duplicated refs tie exactly; the winner must be the lower index, as
    in the XLA argmin and the Pallas kernel's strict-< scan."""
    q = rng.standard_normal((2, 400, 3)).astype(np.float32)
    half = rng.standard_normal((2, 150, 3)).astype(np.float32)
    r = np.concatenate([half, half], axis=1)
    _, idx = knn.nearest_neighbor(torch.from_numpy(q), torch.from_numpy(r))
    idx = to_np(idx)
    assert idx.max() < 150
    for bi in range(2):
        _, want = nearest_neighbor_xla(jnp.asarray(q[bi]), jnp.asarray(r[bi]))
        np.testing.assert_array_equal(idx[bi], np.asarray(want))
    got_c, _ = _plain(q, r)
    np.testing.assert_array_equal(got_c, _pallas(q, r)[0])


def test_remap_active_mask(rng):
    q = rng.standard_normal((3, 100, 3)).astype(np.float32)
    r = rng.standard_normal((3, 80, 3)).astype(np.float32)
    active = np.array([1, 0, 1], np.int32)
    got_c, got_s = _plain(q, r, active)
    want_c, want_s = _pallas(q, r, active.astype(bool))
    assert not got_c[1].any() and not got_s[1].any()
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-5)


def test_nearest_neighbor_distances(rng):
    q = rng.standard_normal((2, 90, 3)).astype(np.float32)
    r = rng.standard_normal((2, 70, 3)).astype(np.float32)
    d, i = knn.nearest_neighbor(torch.from_numpy(q), torch.from_numpy(r))
    brute = ((q[:, :, None] - r[:, None]) ** 2).sum(-1)
    np.testing.assert_array_equal(to_np(i), brute.argmin(-1))
    np.testing.assert_allclose(to_np(d), brute.min(-1), rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_plain_version_without_launch(rng, monkeypatch):
    monkeypatch.setattr(knn.adds_remap_kernel, "launches", 0)
    q = torch.from_numpy(rng.standard_normal((2, 10, 3)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((2, 12, 3)).astype(np.float32))
    knn.adds_remap(q, r, torch.tensor([True, False]))
    assert knn.adds_remap_kernel.launches == 0
