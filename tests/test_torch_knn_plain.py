"""The plain top-k of the k-NN (``knn_cuda.topk_candidates_plain``, the CPU
path of K1 and its oracle on the card) takes its k nearest by rounds of
argmin: the first k of a stable sort of all candidates, bit for bit, on
inputs full of ties and missing candidates."""

import numpy as np
import torch

from liorf_tpu_torch.ops import knn_cuda


def _stable_sort_topk(queries, cand_xyz, cand_idx, k):
    """The contract written as a full stable sort (how the port computed it
    before the argmin rounds)."""
    n, c = cand_idx.shape
    d2 = knn_cuda._sq_dist(cand_xyz, queries[:, None, :])
    d2 = torch.where(d2 < knn_cuda._BIG * 0.5, d2, torch.inf)
    if c < k:
        pad = torch.full((n, k - c), torch.inf)
        d2 = torch.cat([d2, pad], dim=1)
        cand_idx = torch.cat([cand_idx, torch.zeros_like(pad, dtype=cand_idx.dtype)], dim=1)
    vals, pos = torch.sort(d2, dim=1, stable=True)
    vals, pos = vals[:, :k], pos[:, :k]
    idx = torch.where(torch.isfinite(vals), torch.gather(cand_idx, 1, pos), 0)
    return vals, idx.to(torch.int32)


def test_argmin_rounds_equal_a_stable_sort():
    rng = np.random.default_rng(0)
    for _ in range(150):
        n, c, k = int(rng.integers(1, 40)), int(rng.integers(1, 50)), int(rng.integers(1, 9))
        q = torch.tensor(np.round(rng.normal(size=(n, 3)) * 2) / 2, dtype=torch.float32)
        cand = torch.tensor(np.round(rng.normal(size=(n, c, 3)) * 2) / 2, dtype=torch.float32)
        cand[torch.tensor(rng.uniform(size=(n, c)) < 0.3)] = 1e30  # missing candidates
        idx = torch.tensor(rng.integers(0, 1000, size=(n, c)), dtype=torch.int32)
        got = knn_cuda.topk_candidates_plain(q, cand, idx, k)
        want = _stable_sort_topk(q, cand, idx, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (n, c, k)
