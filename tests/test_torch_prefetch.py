"""``utils.prefetch``: the staged clouds and batches equal what
``make_cloud`` and ``torch.as_tensor`` give, in order, with ``depth``
items staged ahead of the consumer."""

import numpy as np
import pytest
import torch

from pgslam_tpu_torch.cloud import make_cloud
from pgslam_tpu_torch.utils.prefetch import prefetch_batches, prefetch_clouds


def _scans(n=6):
    rng = np.random.default_rng(0)
    out = [rng.normal(size=(10 + i, 3)).astype(np.float32)
           for i in range(n)]
    out[2] = (out[2] * 1000).astype(np.int16)      # millimetre packets
    return out


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_clouds_in_order_equal_make_cloud(depth):
    scans = _scans()
    got = list(prefetch_clouds(scans, capacity=32, depth=depth,
                               device="cpu"))
    assert len(got) == len(scans)
    for g, s in zip(got, scans):
        want = make_cloud(s, capacity=32)
        assert torch.equal(g.points, want.points)
        assert torch.equal(g.mask, want.mask)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_depth_items_are_staged_ahead(depth):
    pulled = []

    def source():
        for i, s in enumerate(_scans()):
            pulled.append(i)
            yield s

    it = prefetch_clouds(source(), capacity=32, depth=depth, device="cpu")
    next(it)
    assert len(pulled) == depth + 1
    next(it)
    assert len(pulled) == depth + 2


def test_depth_must_be_positive():
    with pytest.raises(ValueError):
        next(prefetch_clouds(_scans(), capacity=32, depth=0, device="cpu"))


def test_batches_copy_arrays_and_keep_the_rest():
    batches = [{"clouds": np.full((2, 4, 3), i, np.float32),
                "ids": [np.arange(2), "agent"], "step": i}
               for i in range(3)]
    got = list(prefetch_batches(batches, depth=2, device="cpu"))
    for i, b in enumerate(got):
        assert torch.equal(b["clouds"], torch.full((2, 4, 3), float(i)))
        assert torch.equal(b["ids"][0], torch.arange(2))
        assert b["ids"][1] == "agent" and b["step"] == i


def test_the_card_is_the_default():
    if torch.cuda.is_available():
        pytest.skip("with CUDA the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(prefetch_clouds(_scans(), capacity=32))


def test_counters_stay_where_they_were():
    from pgslam_tpu_torch import utils
    assert utils.counters["no/such/key"] == 0.0
