"""K1 (exact masked k-NN): the port's plain version against the JAX
brute-force search and the Pallas kernel (interpret mode on the CPU). The
CUDA kernel is held against the plain version in tests/test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgslam_tpu.ops.knn import knn_brute_force
from pgslam_tpu.ops.knn_pallas import nn_pallas
from pgslam_tpu_torch.ops.knn import knn

# d2 is |q|^2 - 2 q.r + |r|^2 in fp32: its error scales with the squared
# norms, not with d2, and the two frameworks round the sum in different
# orders. The tolerance is 1e-5 relative to that scale.
D2_RTOL = 1e-5


def _d2_atol(q, r):
    return D2_RTOL * float(np.max(np.sum(q * q, 1)) + np.max(np.sum(r * r, 1)))


def _case(nq, nr, seed, span=10.0, q_masked=(), r_masked_from=None):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-span, span, (nq, 3)).astype(np.float32)
    r = rng.uniform(-span, span, (nr, 3)).astype(np.float32)
    qm = np.ones(nq, bool)
    qm[list(q_masked)] = False
    rm = np.ones(nr, bool)
    if r_masked_from is not None:
        rm[r_masked_from:] = False
    return q, qm, r, rm


def _port(q, qm, r, rm, k):
    m = knn(torch.from_numpy(q), torch.from_numpy(qm), torch.from_numpy(r),
            torch.from_numpy(rm), k=k)
    return m.dists2.numpy(), m.ids.numpy()


@pytest.mark.parametrize("k,nq,nr,seed", [(1, 700, 1500, 0), (1, 130, 257, 1),
                                          (8, 300, 900, 2), (8, 257, 131, 3)])
def test_plain_matches_knn_brute_force(k, nq, nr, seed):
    q, qm, r, rm = _case(nq, nr, seed, q_masked=(3, 10),
                         r_masked_from=nr * 2 // 3)
    b = knn_brute_force(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(r),
                        jnp.asarray(rm), k=k)
    d, i = _port(q, qm, r, rm, k)
    # knn_brute_force does not mask queries; K1 gives them +inf, id 0.
    np.testing.assert_array_equal(i[qm], np.asarray(b.ids)[qm])
    np.testing.assert_allclose(d[qm], np.asarray(b.dists2)[qm], rtol=0,
                               atol=_d2_atol(q, r))
    assert not np.isfinite(d[~qm]).any() and (i[~qm] == 0).all()


@pytest.mark.parametrize("k", [1, 4, 8])
def test_plain_matches_nn_pallas_interpret(k):
    q, qm, r, rm = _case(130, 257, 5, q_masked=(7,), r_masked_from=200)
    p = nn_pallas(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(r),
                  jnp.asarray(rm), k=k, tile_q=64, tile_r=128)
    d, i = _port(q, qm, r, rm, k)
    np.testing.assert_array_equal(i, np.asarray(p.ids))
    fin = np.isfinite(np.asarray(p.dists2))
    np.testing.assert_array_equal(np.isfinite(d), fin)
    np.testing.assert_allclose(d[fin], np.asarray(p.dists2)[fin],
                               rtol=1e-3, atol=1e-4)


def test_too_few_references_and_ties():
    # k exceeds the valid references: surplus slots are +inf / id 0.
    q, qm, r, rm = _case(16, 64, 6)
    rm[:] = False
    rm[[5, 9]] = True
    d, i = _port(q, qm, r, rm, 4)
    assert np.isfinite(d[:, :2]).all() and not np.isfinite(d[:, 2:]).any()
    assert (i[:, 2:] == 0).all() and (d[:, 0] <= d[:, 1]).all()
    # exact duplicates: the lowest id wins, then the next
    r2 = np.concatenate([r[:10], r[:10]])
    d, i = _port(r[:10].copy(), np.ones(10, bool), r2, np.ones(20, bool), 2)
    np.testing.assert_array_equal(i, np.stack([np.arange(10),
                                               np.arange(10) + 10], 1))
    np.testing.assert_array_equal(d, 0.0)


def test_wrapper_rejects_bad_k():
    q, qm, r, rm = _case(4, 8, 0)
    with pytest.raises(ValueError):
        knn(torch.from_numpy(q), torch.from_numpy(qm), torch.from_numpy(r),
            torch.from_numpy(rm), k=9)
