"""ICP's alignment step in one call (``ops/icp_align.py``): Horn's quaternion
rotation against the JAX package's SVD Kabsch (generic, near-planar and
reflected correspondences), one step against a float64 Kabsch on the same
correspondences, frozen lanes and lane independence; and on the card (marker
``gpu``) the kernel against its plain version, lanes against single launches.
Without JAX on the card:

    python -m pytest tests/test_torch_icp_align.py -m gpu -q --noconftest
"""

import numpy as np
import pytest
import torch

from liorf_tpu_torch.ops import icp_align as ia
from liorf_tpu_torch.ops import knn as tknn
from liorf_tpu_torch.ops import scan_gn

MAX_D2, EPS = 900.0, 1e-6


def _rot(v):
    v = np.asarray(v, np.float64)
    t = np.linalg.norm(v)
    K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]]) / t
    return np.eye(3) + np.sin(t) * K + (1 - np.cos(t)) * K @ K


def _cross_cov(src, tgt):
    """S[i][j] = sum of (tgt_i - mean)(src_j - mean), float32."""
    ds, dt = src - src.mean(0), tgt - tgt.mean(0)
    return (dt.T @ ds).astype(np.float32)


def _cases():
    rng = np.random.default_rng(7)
    src = rng.uniform(-10, 10, (400, 3))
    R = _rot([0.3, -0.2, 0.5])
    generic = _cross_cov(src, src @ R.T + rng.normal(0, 0.05, src.shape))
    flat = src.copy()
    flat[:, 2] = rng.normal(0, 1e-3, len(src))  # near-planar: S of rank ~2
    planar = _cross_cov(flat, flat @ R.T + rng.normal(0, 0.01, src.shape))
    mirror = src * np.array([1.0, 1.0, -1.0])  # the best orthogonal map is a reflection
    reflect = _cross_cov(src, mirror @ R.T + rng.normal(0, 0.05, src.shape))
    return {"generic": generic, "near_planar": planar, "reflection": reflect}


CASES = _cases()


@pytest.mark.parametrize("name", list(CASES))
def test_horn_matches_jax_svd_kabsch(name):
    """Horn's quaternion (Jacobi on the 4x4 matrix, float64) against the JAX
    package's Kabsch (``U diag(1, 1, det(U V^T)) V^T`` of float32 SVD,
    liorf_tpu/ops/icp.py:81-84): the same proper rotation, to 1e-5 (the
    float32 SVD's own rounding over S's singular-value gaps); the reflection
    case is one, det(U V^T) < 0."""
    import jax.numpy as jnp

    S = CASES[name]
    U, _, Vt = jnp.linalg.svd(jnp.asarray(S))
    det = jnp.linalg.det(U @ Vt)
    assert (float(det) < 0) == (name == "reflection")
    Rj = np.asarray(U @ jnp.diag(jnp.array([1.0, 1.0, det])) @ Vt)
    R = ia.horn_rotation(torch.as_tensor(S, dtype=torch.float64)[None])[0].numpy()
    np.testing.assert_allclose(R, Rj, atol=1e-5)
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)
    assert np.linalg.det(R) > 0


def _icp_case(seed, n=700, m=1500):
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(-15, 15, (m, 3)).astype(np.float32)
    tgt[: m // 3, 2] = 0.0
    tgt[m // 3: 2 * m // 3, 0] = 15.0
    true_R, true_t = _rot([0.01, -0.02, 0.05]), np.array([0.4, -0.3, 0.1])
    src_world = tgt[rng.permutation(m)[:n]] + rng.normal(0, 0.01, (n, 3))
    src = ((src_world - true_t) @ true_R).astype(np.float32)
    mask = rng.uniform(size=n) > 0.05
    pose = np.array([0.005, -0.01, 0.02, 0.2, -0.1, 0.05], np.float32)
    return src, mask, tgt, pose


def _inputs(src, mask, tgt, pose, device="cpu"):
    dev = torch.device(device)
    s = torch.as_tensor(src, device=dev)[None].contiguous()
    m = torch.as_tensor(mask, device=dev)[None].contiguous()
    t = torch.as_tensor(tgt, device=dev)[None].contiguous()
    st = ia.init_state(torch.as_tensor(pose, device=dev)[None])
    moved = scan_gn.transform_plain(st.pose, s)
    d2, idx = tknn.knn_bruteforce(t, torch.ones(t.shape[:2], dtype=torch.bool, device=dev),
                                  moved, m, k=1)
    return st, moved, d2, idx, t, m, s


def test_one_step_matches_a_float64_kabsch():
    """One alignment step against a float64 Kabsch (numpy's SVD) on the same
    correspondences, composed with the same rotation: the new pose within
    2e-6 (m, rad): the float32 sums of ~650 terms and the one rounding of
    the pose."""
    src, mask, tgt, pose = _icp_case(3)
    st, moved, d2, idx, t, m, s = _inputs(src, mask, tgt, pose)
    new, moved_next, all_done = ia.icp_align_plain(st, moved, d2, idx, t, m, s, MAX_D2, EPS)
    ok = (m[0] & torch.isfinite(d2[0, :, 0]) & (d2[0, :, 0] < MAX_D2)).numpy()
    ms = moved[0].numpy().astype(np.float64)[ok]
    mt = tgt.astype(np.float64)[idx[0, :, 0].numpy()][ok]
    S = (mt - mt.mean(0)).T @ (ms - ms.mean(0))
    U, _, Vt = np.linalg.svd(S)
    Rd = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt
    td = mt.mean(0) - Rd @ ms.mean(0)
    R0 = scan_gn.rot_f32(st.pose[:, :3])[0].double().numpy()
    Rn, tn = Rd @ R0, Rd @ pose[3:].astype(np.float64) + td
    want = np.array([np.arctan2(Rn[2, 1], Rn[2, 2]), np.arcsin(-Rn[2, 0]),
                     np.arctan2(Rn[1, 0], Rn[0, 0]), *tn])
    np.testing.assert_allclose(new.pose[0].numpy(), want, atol=2e-6)
    assert int(new.iters[0]) == 1 and not bool(all_done[0])
    assert torch.equal(moved_next, scan_gn.transform_plain(new.pose, s))


def test_lanes_equal_single_lanes_and_done_lanes_stay():
    """A lane of a stacked call has the bits of a call on that lane; a lane
    already done keeps its pose and iterations."""
    lanes = [_inputs(*_icp_case(s)) for s in (1, 2)]
    st = ia.ICPState(*(torch.cat(x) for x in zip(*(ln[0] for ln in lanes))))
    st = st._replace(done=torch.tensor([False, True]))
    rest = [torch.cat(x) for x in zip(*(ln[1:] for ln in lanes))]
    new, moved, _ = ia.icp_align_plain(st, *rest, MAX_D2, EPS)
    one, one_moved, _ = ia.icp_align_plain(lanes[0][0], *lanes[0][1:], MAX_D2, EPS)
    assert torch.equal(new.pose[:1], one.pose) and torch.equal(moved[:1], one_moved)
    assert torch.equal(new.pose[1], st.pose[1]) and new.iters.tolist() == [1, 0]
    assert torch.equal(moved[1:], lanes[1][1])  # the frozen lane's source stays where it was


def test_wrapper_takes_the_plain_version_on_the_cpu():
    ia.reset_launch_counts()
    ia.icp_align(*_inputs(*_icp_case(4, n=200, m=300)), MAX_D2, EPS)
    assert ia.launch_counts() == {"icp_align": 0}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    # decided here, not at import: every xdist worker must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [1, 5])
def test_kernel_is_its_plain_version(dev, seed):
    """Bit for bit against the plain version on the card (torch's float64
    asin / atan2 there and the kernel's are CUDA's); a second launch repeats."""
    args = _inputs(*_icp_case(seed, n=5000, m=8000), device=dev)
    before = ia.icp_align.launches
    got = ia.icp_align(*args, MAX_D2, EPS)
    again = ia.icp_align(*args, MAX_D2, EPS)
    want = ia.icp_align_plain(*args, MAX_D2, EPS)
    assert ia.icp_align.launches == before + 2
    for x, y, z in zip((*got[0], got[1], got[2]), (*want[0], want[1], want[2]),
                       (*again[0], again[1], again[2])):
        assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.gpu
def test_lanes_equal_single_launches(dev):
    lanes = [_inputs(*_icp_case(s, n=3000, m=4000), device=dev) for s in range(4)]
    st = ia.ICPState(*(torch.cat(x) for x in zip(*(ln[0] for ln in lanes))))
    rest = [torch.cat(x).contiguous() for x in zip(*(ln[1:] for ln in lanes))]
    new, moved, _ = ia.icp_align(st, *rest, MAX_D2, EPS)
    for b, ln in enumerate(lanes):
        one, one_moved, _ = ia.icp_align(*ln, MAX_D2, EPS)
        for x, y in zip(new, one):
            assert torch.equal(x[b:b + 1], y)
        assert torch.equal(moved[b:b + 1], one_moved)


@pytest.mark.gpu
def test_wrapper_checks_its_arguments(dev):
    st, moved, d2, idx, t, m, s = _inputs(*_icp_case(2, n=300, m=400), device=dev)
    with pytest.raises(TypeError):
        ia.icp_align(st, moved, d2, idx.long(), t, m, s, MAX_D2, EPS)
    with pytest.raises(ValueError):
        ia.icp_align(st, moved, d2, idx, t.cpu(), m, s, MAX_D2, EPS)
