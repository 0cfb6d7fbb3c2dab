"""Visualization export of the port (``mapping/viz.py``, ``cli run --viz``)
against the JAX package's: the PLY files of one keyframe store and one set
of loop pairs are equal byte for byte."""

import json
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import torch

from liorf_tpu.mapping import viz as jviz
from liorf_tpu_torch import cli, convert
from liorf_tpu_torch.mapping import viz as tviz


def _store():
    """Six keyframes of 300 points (some masked) on a gentle arc, from a
    seed: the port's KeyframeStore, whose numpy fields both packages read."""
    rng = np.random.default_rng(0)
    k, c = 6, 300
    poses = np.zeros((k, 6), np.float32)
    poses[:, 2] = np.linspace(0.0, 0.6, k)
    poses[:, 3] = np.linspace(0.0, 10.0, k)
    poses[:, 4] = 0.3 * np.arange(k) ** 2
    poses[:, 5] = rng.normal(scale=0.05, size=k)
    clouds = rng.uniform(-20, 20, size=(k, c, 3)).astype(np.float32)
    clouds[..., 2] *= 0.1
    masks = rng.uniform(size=(k, c)) > 0.1
    fields = dict(poses=poses, times=np.arange(k, dtype=np.float64) * 0.5, clouds=clouds,
                  cloud_masks=masks, sc_descs=np.zeros((k, 20, 60), np.float32),
                  sc_keys=np.zeros((k, 20), np.float32))
    return convert.keyframe_store_from_arrays(fields, k, device="cpu")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_export_ply_equals_jax_and_png(tmp_path):
    """Classic pipelines (pairs from the loop detector) and resident ones
    (pairs from l_count / l_i / l_j in the state) give the JAX module's PLY
    bytes; render_overview writes a PNG over 10 kB (tests/test_viz.py:21)."""
    store = _store()
    loops = {4: 0, 5: 1}
    l_i, l_j = [0, 1, 0], [4, 5, 0]  # the third slot lies past l_count
    classic = SimpleNamespace(store=store, loop_detector=SimpleNamespace(loop_index_container=loops))
    t_res = SimpleNamespace(store=store, state=SimpleNamespace(
        l_count=torch.tensor(2), l_i=torch.tensor(l_i), l_j=torch.tensor(l_j)))
    j_res = SimpleNamespace(store=store, state=SimpleNamespace(
        l_count=jnp.asarray(2, jnp.int32), l_i=jnp.asarray(l_i, jnp.int32),
        l_j=jnp.asarray(l_j, jnp.int32)))
    for name, tp, jp in (("classic", classic, classic), ("resident", t_res, j_res)):
        ta = tviz.export_ply(tp, str(tmp_path / f"t_{name}"))
        ja = jviz.export_ply(jp, str(tmp_path / f"j_{name}"))
        assert set(ta) == set(ja) == {"trajectory", "map", "loops"}
        for key in ta:
            assert _read(ta[key]) == _read(ja[key]), (name, key)
    np.testing.assert_array_equal(tviz._loop_pairs(t_res), [[0, 4], [1, 5]])
    head = _read(ta["map"])[:200].decode()
    n_map = int(store.cloud_masks[: store.count].sum())
    assert f"element vertex {n_map}\n" in head
    png = tviz.render_overview(t_res, str(tmp_path / "ov.png"))
    assert os.path.getsize(png) > 10_000


def test_cli_run_viz(tmp_path, capsys):
    """``cli run --viz --device cpu`` writes trajectory.ply (one vertex a
    keyframe), map.ply and, matplotlib being installed here, overview.png,
    then the JSON line."""
    cfg = tmp_path / "small.yaml"
    cfg.write_text(
        "liorf:\n  scan_capacity: 4096\n  map_capacity: 16384\n  kf_cloud_capacity: 2048\n"
        "  near_kf_capacity: 8\n  imu_window: 32\n  kf_capacity: 16\n  traj_capacity: 32\n"
        "  gps_capacity: 8\n  loop_capacity: 8\n  imu_rate_capacity: 1024\n"
    )
    out = str(tmp_path / "out")
    cli.main(["run", "--dataset", "synthetic", "--frames", "4", "--out", out, "--device", "cpu",
              "--config", str(cfg), "--viz"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["frames"] == 4 and line["out"] == out
    traj = _read(os.path.join(out, "trajectory.ply")).decode()
    assert f"element vertex {line['keyframes']}\n" in traj
    gm = _read(os.path.join(out, "map.ply")).decode()
    n_map = int(gm.split("element vertex ")[1].split("\n")[0])
    assert n_map > 100 and len(gm.split("end_header\n")[1].splitlines()) == n_map
    assert os.path.getsize(os.path.join(out, "overview.png")) > 10_000
