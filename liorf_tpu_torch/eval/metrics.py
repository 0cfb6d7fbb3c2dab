"""Trajectory evaluation: ATE / RPE with Umeyama alignment, TUM-format I/O.

The reference validates with the external `evo` toolchain on TUM-format
trajectories (``liorf/README.md`` demo plots, ``demo/*_ape.png``);
this module makes those metrics built-in so benchmark tables are
reproducible without ROS. Conventions follow evo: ATE = RMSE of translation
after SE(3) (or Sim(3)-without-scale) alignment; RPE = RMSE of relative pose
deltas over a fixed frame step.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares rigid alignment src -> dst: returns (R, t, s).

    src/dst: [N, 3]. Umeyama (1991); scale fixed at 1 unless with_scale.
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ate_rmse(est_xyz: np.ndarray, gt_xyz: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error (RMSE of translation), evo-style."""
    assert est_xyz.shape == gt_xyz.shape
    if align:
        R, t, s = umeyama_alignment(est_xyz, gt_xyz)
        est_xyz = est_xyz @ (s * R).T + t
    d = est_xyz - gt_xyz
    return float(np.sqrt((d**2).sum(axis=1).mean()))


def _rot_angles_deg(R: np.ndarray) -> np.ndarray:
    """Batch rotation-matrix -> rotation angle in degrees."""
    tr = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    return np.degrees(np.arccos(tr))


def ate_rot_rmse_deg(
    est_xyz: np.ndarray,
    est_quat_wxyz: np.ndarray,
    gt_xyz: np.ndarray,
    gt_quat_wxyz: np.ndarray,
    align: bool = True,
) -> float:
    """Rotational APE (evo ``--pose_relation angle_deg``): RMSE of the
    rotation angle of Q_i^-1 · (R_align · P_i) after the same SE(3) Umeyama
    alignment ATE uses (the alignment rotation left-multiplies the estimate;
    the metric behind the reference's ``demo/kitti05_ape.png`` family)."""
    from ..core.se3np import quat_wxyz_to_rot

    R_est = quat_wxyz_to_rot(est_quat_wxyz)
    R_gt = quat_wxyz_to_rot(gt_quat_wxyz)
    if align:
        R_a, _, _ = umeyama_alignment(est_xyz, gt_xyz)
        R_est = R_a[None] @ R_est
    E = np.swapaxes(R_gt, -1, -2) @ R_est
    return float(np.sqrt((_rot_angles_deg(E) ** 2).mean()))


def rpe_se3(
    est_xyz: np.ndarray,
    est_quat_wxyz: np.ndarray,
    gt_xyz: np.ndarray,
    gt_quat_wxyz: np.ndarray,
    delta: int = 1,
) -> tuple[float, float]:
    """evo-faithful SE(3) relative pose error over a frame delta.

    For each pair (i, i+delta):
        E_i = (Q_i^-1 Q_{i+d})^-1 (P_i^-1 P_{i+d})
    with P = estimate, Q = ground truth (both full SE(3)). Returns
    (trans_rmse_m, rot_rmse_deg): RMSE of ||trans(E_i)|| and of the
    rotation angle of rot(E_i). This is the metric behind the reference's
    ``demo/kitti05_rpe.png`` (evo_rpe on TUM trajectories) — NOT the
    step-length difference |‖Δest‖−‖Δgt‖|, which ignores direction and
    rotation entirely.
    """
    from ..core.se3np import quat_wxyz_to_rot

    n = len(est_xyz) - delta
    if n <= 0:
        return 0.0, 0.0
    R_p = quat_wxyz_to_rot(est_quat_wxyz)
    R_q = quat_wxyz_to_rot(gt_quat_wxyz)
    # relative motions: rot = R_i^T R_{i+d}, trans = R_i^T (t_{i+d} - t_i)
    Rp_rel = np.swapaxes(R_p[:-delta], -1, -2) @ R_p[delta:]
    tp_rel = np.einsum(
        "nij,ni->nj", R_p[:-delta], est_xyz[delta:] - est_xyz[:-delta]
    )
    Rq_rel = np.swapaxes(R_q[:-delta], -1, -2) @ R_q[delta:]
    tq_rel = np.einsum(
        "nij,ni->nj", R_q[:-delta], gt_xyz[delta:] - gt_xyz[:-delta]
    )
    # E = Q_rel^-1 P_rel
    E_R = np.swapaxes(Rq_rel, -1, -2) @ Rp_rel
    E_t = np.einsum("nji,ni->nj", Rq_rel, tp_rel - tq_rel)
    trans_rmse = float(np.sqrt((np.linalg.norm(E_t, axis=1) ** 2).mean()))
    rot_rmse = float(np.sqrt((_rot_angles_deg(E_R) ** 2).mean()))
    return trans_rmse, rot_rmse


def rpe_rmse(
    est_xyz: np.ndarray,
    gt_xyz: np.ndarray,
    delta: int = 10,
    est_quat_wxyz: np.ndarray | None = None,
    gt_quat_wxyz: np.ndarray | None = None,
) -> float:
    """Translation-part RPE (evo ``--pose_relation trans_part``).

    With quaternions this is exact evo semantics (via :func:`rpe_se3`).
    Without them the relative translations can only be compared in the
    world frame, ||Δest − Δgt|| — direction-sensitive (unlike the old
    step-length difference) but not frame-local; pass quaternions when
    available."""
    n = len(est_xyz) - delta
    if n <= 0:
        return 0.0
    if est_quat_wxyz is not None and gt_quat_wxyz is not None:
        return rpe_se3(est_xyz, est_quat_wxyz, gt_xyz, gt_quat_wxyz, delta)[0]
    d = (est_xyz[delta:] - est_xyz[:-delta]) - (gt_xyz[delta:] - gt_xyz[:-delta])
    return float(np.sqrt((np.linalg.norm(d, axis=1) ** 2).mean()))


def associate(
    t_a: np.ndarray, t_b: np.ndarray, max_diff: float = 0.02
) -> tuple[np.ndarray, np.ndarray]:
    """Timestamp association (TUM associate.py / evo semantics).

    Returns index arrays (ia, ib) of matched pairs: candidate pairs within
    ``max_diff`` are taken greedily in order of ascending |Δt|, each index
    used at most once. Comparing trajectories by row number silently
    misaligns whenever the two files sample different clocks — associate
    first, then slice."""
    t_a = np.asarray(t_a, np.float64)
    t_b = np.asarray(t_b, np.float64)
    if len(t_a) == 0 or len(t_b) == 0:
        return np.zeros(0, int), np.zeros(0, int)
    order = np.argsort(t_b, kind="stable")
    tb_sorted = t_b[order]
    pos = np.searchsorted(tb_sorted, t_a)
    cands = []
    # two bracketing candidates per query plus one more on each side: on
    # dense/offset clocks the bracketing pair can both be claimed by closer
    # queries during the greedy pass, and a third-nearest stamp within
    # max_diff would legally match (TUM associate.py considers all pairs)
    for j_off in (-2, -1, 0, 1):
        j = np.clip(pos + j_off, 0, len(tb_sorted) - 1)
        diff = np.abs(t_a - tb_sorted[j])
        cands.append((diff, np.arange(len(t_a)), order[j]))
    diff = np.concatenate([c[0] for c in cands])
    ia = np.concatenate([c[1] for c in cands])
    ib = np.concatenate([c[2] for c in cands])
    keep = diff <= max_diff
    diff, ia, ib = diff[keep], ia[keep], ib[keep]
    sel_a: set[int] = set()
    sel_b: set[int] = set()
    out_a, out_b = [], []
    for k in np.argsort(diff, kind="stable"):
        a, b = int(ia[k]), int(ib[k])
        if a in sel_a or b in sel_b:
            continue
        sel_a.add(a)
        sel_b.add(b)
        out_a.append(a)
        out_b.append(b)
    oa = np.asarray(out_a, int)
    ob = np.asarray(out_b, int)
    srt = np.argsort(oa)
    return oa[srt], ob[srt]


def save_tum(path: str, times: np.ndarray, xyz: np.ndarray, quat_wxyz: np.ndarray):
    """Write a TUM trajectory file: `t x y z qx qy qz qw` per line."""
    with open(path, "w") as f:
        for t, p, q in zip(times, xyz, quat_wxyz):
            f.write(
                f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n"
            )


def load_tum(path: str):
    """Read a TUM trajectory file -> (times [N], xyz [N,3], quat_wxyz [N,4])."""
    data = np.loadtxt(path).reshape(-1, 8)
    times = data[:, 0]
    xyz = data[:, 1:4]
    q_xyzw = data[:, 4:8]
    quat_wxyz = np.concatenate([q_xyzw[:, 3:4], q_xyzw[:, 0:3]], axis=1)
    return times, xyz, quat_wxyz
