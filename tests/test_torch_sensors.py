"""The port's host data path against the JAX package's: the KITTI, MulRan and
rosbag readers on files written into ``tmp_path`` (the writers of
tests/test_sensors.py and tests/test_rosbag.py), the native runtime
(``liorf_tpu_torch.native``: scan packer, PointCloud2 extraction, bz2) against
the JAX package's and numpy, and ``cli run --dataset rosbag`` end to end on
the CPU."""

import bz2 as py_bz2
import json
import os
import struct

import numpy as np
import pytest

from liorf_tpu import native as jnative
from liorf_tpu.sensors import kitti as jkitti
from liorf_tpu.sensors import mulran as jmulran
from liorf_tpu.sensors import rosbag as jrosbag
from liorf_tpu_torch import cli, native
from liorf_tpu_torch.pipeline import ResidentPipeline, SlamConfig
from liorf_tpu_torch.sensors import kitti, mulran, rosbag
from liorf_tpu_torch.sensors.synthetic import SyntheticConfig, SyntheticDataset
from test_rosbag import serialize_imu, serialize_navsatfix, serialize_pointcloud2, write_bag
from test_sensors import _write_kitti_drive


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    assert lib is not None, f"the native library did not build: {native.build_error}"
    return lib


def _same_scan(a, b):
    for f in ("xyz", "intensity", "ring", "rel_time"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.stamp == b.stamp and a.end_time == b.end_time


def _same_imu(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.stamp == y.stamp
        np.testing.assert_array_equal(x.acc, y.acc)
        np.testing.assert_array_equal(x.gyr, y.gyr)
        np.testing.assert_array_equal(
            np.asarray(x.quat_wxyz if x.quat_wxyz is not None else []),
            np.asarray(y.quat_wxyz if y.quat_wxyz is not None else []),
        )


def _same_gps(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.stamp, x.lat, x.lon, x.alt) == (y.stamp, y.lat, y.lon, y.alt)
        np.testing.assert_array_equal(x.cov_xyz, y.cov_xyz)


def test_kitti_reader_matches_jax(tmp_path, rng):
    root = _write_kitti_drive(str(tmp_path), rng=rng)
    a, b = kitti.KittiRawDataset(root), jkitti.KittiRawDataset(root)
    assert len(a) == len(b) == 3
    for i in range(len(a)):
        _same_scan(a.scan(i), b.scan(i))
    _same_imu(a.imu_stream(), b.imu_stream())
    _same_gps(a.gps_stream(), b.gps_stream())


def test_mulran_reader_matches_jax(tmp_path, rng):
    sd = os.path.join(str(tmp_path), "sensor_data")
    os.makedirs(os.path.join(sd, "Ouster"))
    for i in range(3):
        pts = rng.uniform(-20, 20, size=(64, 4)).astype(np.float32)
        pts.tofile(os.path.join(sd, "Ouster", f"{1561000000000000000 + i * 100000000}.bin"))
    with open(os.path.join(sd, "xsens_imu.csv"), "w") as f:
        for i in range(5):
            f.write(f"{1561000000000000000 + i * 10000000},0,0,0,1,0,0,0,0.01,0.02,0.03,0.1,0.2,9.8\n")
    with open(os.path.join(sd, "gps.csv"), "w") as f:
        f.write("1561000000000000000,37.5,127.0,50.0," + ",".join(["0.04"] * 9) + "\n")
    a, b = mulran.MulranDataset(str(tmp_path)), jmulran.MulranDataset(str(tmp_path))
    assert len(a) == len(b) == 3
    for i in range(len(a)):
        _same_scan(a.scan(i), b.scan(i))
    _same_imu(a.imu_stream(), b.imu_stream())
    _same_gps(a.gps_stream(), b.gps_stream())


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_rosbag_reader_matches_jax(tmp_path, rng, compression):
    """Two clouds, IMU and GPS in one bag, plain and bz2 chunks (the port
    decodes them with its native library)."""
    msgs = []
    for k, stamp in enumerate((10.0, 10.1)):
        xyz = rng.uniform(-20, 20, size=(100, 3)).astype(np.float32)
        msgs.append(("/points_raw", "sensor_msgs/PointCloud2", stamp, serialize_pointcloud2(
            stamp, xyz, rng.uniform(0, 1, 100).astype(np.float32),
            rng.integers(0, 16, 100).astype(np.uint16),
            np.linspace(0, 0.1, 100).astype(np.float32))))
        msgs.append(("/imu_raw", "sensor_msgs/Imu", stamp - 0.01, serialize_imu(
            stamp - 0.01, [0.1, 0.2, 9.8 + k], [0.01, 0.02, 0.03], [1, 0, 0, 0])))
    msgs.append(("/gps/fix", "sensor_msgs/NavSatFix", 10.05,
                 serialize_navsatfix(10.05, 47.1, 8.2, 420.0, [0.25, 0.25, 1.0])))
    msgs.sort(key=lambda m: m[2])
    path = str(tmp_path / "test.bag")
    write_bag(path, msgs, compression=compression)
    kw = dict(cloud_topic="/points_raw", imu_topic="/imu_raw", gps_topic="/gps/fix",
              sensor="velodyne")
    a, b = rosbag.RosbagDataset(path, **kw), jrosbag.RosbagDataset(path, **kw)
    assert len(a) == len(b) == 2
    for i in range(len(a)):
        _same_scan(a.scan(i), b.scan(i))
    _same_imu(a.imu_stream(), b.imu_stream())
    _same_gps(a.gps_stream(), b.gps_stream())


def test_native_pack_scan_matches_jax_and_numpy(lib, rng):
    """ln_pack_scan against the JAX package's native packer and the numpy
    compaction of the port (``_pack_scan``), with NaN/inf points, ring
    decimation, point stride and a truncating capacity."""
    n = 7000
    xyz = rng.normal(scale=30.0, size=(n, 3)).astype(np.float32)
    xyz[::13] = np.nan
    xyz[1::97] = np.inf
    rel = rng.random(n).astype(np.float64) * 0.1
    ring = (np.arange(n) % 16).astype(np.int32)
    for cap, dsr, pfn in ((2048, 2, 3), (512, 1, 1)):
        cfg = SlamConfig(scan_capacity=cap, raw_capacity=cap, downsampleRate=dsr,
                         point_filter_num=pfn)
        args = (xyz, rel, ring, cfg.lidarMinRange**2, cfg.lidarMaxRange**2, dsr, pfn)
        outs = []
        for mod in (native, jnative):
            x_out, r_out = np.empty((cap, 3), np.float32), np.empty(cap, np.float32)
            m_out = np.empty(cap, np.float32)
            total = mod.pack_scan_into(*args, x_out, r_out, m_out)
            outs.append((total, x_out, r_out, m_out))
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a, b)
        total, x_out, r_out, m_out = outs[0]

        class Scan:
            pass

        scan = Scan()
        scan.xyz, scan.rel_time, scan.ring = xyz, rel, ring
        pipe = ResidentPipeline(cfg, device="cpu")
        x_np, r_np, m_np = pipe._pack_scan(scan)
        kept = int(m_np.sum())
        assert min(total, cap) == kept and (total > cap) == (cap == 512)
        np.testing.assert_array_equal(x_out, x_np)
        np.testing.assert_array_equal(r_out, r_np)
        np.testing.assert_array_equal(m_out > 0.5, m_np)


def test_native_pc2_extract_and_bz2_match_jax_and_numpy(lib, rng):
    n, step = 500, 22
    data = bytearray(n * step)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    inten = rng.uniform(size=n).astype(np.float32)
    ring = rng.integers(0, 64, size=n).astype(np.uint16)
    t = rng.uniform(0, 0.1, size=n).astype(np.float32)
    for i in range(n):
        struct.pack_into("<ffffHf", data, i * step, *xyz[i], inten[i], ring[i], t[i])
    fields = [(0, 7), (4, 7), (8, 7), (12, 7), (16, 4), (18, 7)]
    out = native.pc2_extract(bytes(data), n, step, fields)
    np.testing.assert_array_equal(out, jnative.pc2_extract(bytes(data), n, step, fields))
    np.testing.assert_array_equal(out[:3].T, xyz)
    np.testing.assert_array_equal(out[3], inten)
    np.testing.assert_array_equal(out[4], ring.astype(np.float32))
    np.testing.assert_array_equal(out[5], t)

    raw = b"liorf native runtime " * 200
    comp = py_bz2.compress(raw)
    if not lib.ln_has_bz2():
        pytest.skip("libbz2 not found at runtime")
    assert native.bz2_decompress(comp, len(raw)) == raw == jnative.bz2_decompress(comp, len(raw))


def test_native_prefetcher_roundtrip(lib, tmp_path, rng):
    paths, contents = [], []
    for i in range(6):
        p = tmp_path / f"f{i}.bin"
        c = rng.bytes(1000 + i * 17)
        p.write_bytes(c)
        paths.append(str(p))
        contents.append(c)
    pf = native.FilePrefetcher(paths, n_threads=2, depth=4)
    assert pf.get(1) == contents[1] and pf.get(0) == contents[0]
    assert [pf.get(i) for i in range(2, 6)] == contents[2:]
    pf.close()


def test_resident_pipeline_packs_natively(lib):
    """Every step frame of the port's resident pipeline is packed by the
    native library (frame 0, the bootstrap, takes the numpy compaction, as
    in the JAX package)."""
    syn = SyntheticDataset(SyntheticConfig(n_frames=3, n_rings=8, points_per_ring=120))
    pipe = ResidentPipeline(SlamConfig(scan_capacity=1024, raw_capacity=1024,
                                       map_capacity=4096, kf_cloud_capacity=1024), device="cpu")
    imu = syn.imu_stream()
    ii = 0
    for f in range(3):
        scan = syn.scan(f)
        while ii < len(imu) and imu[ii].stamp <= scan.end_time + 0.02:
            pipe.push_imu(imu[ii])
            ii += 1
        pipe.process_scan(scan)
    assert pipe.packer() == {"native": 2}


def _write_synthetic_bag(path, n_frames=6):
    syn = SyntheticDataset(SyntheticConfig(n_frames=n_frames, n_rings=16, points_per_ring=180))
    msgs = []
    for s in syn.imu_stream():
        if s.stamp < 0.65:
            stamp = max(s.stamp, 0.0)
            msgs.append(("/imu_raw", "sensor_msgs/Imu", stamp,
                         serialize_imu(stamp, s.acc, s.gyr, [1, 0, 0, 0])))
    for f in range(n_frames):
        s = syn.scan(f)
        msgs.append(("/points_raw", "sensor_msgs/PointCloud2", s.stamp, serialize_pointcloud2(
            s.stamp, s.xyz, s.intensity, s.ring.astype(np.uint16), s.rel_time.astype(np.float32))))
    msgs.sort(key=lambda m: m[2])
    write_bag(path, msgs)


def test_cli_run_rosbag(tmp_path, capsys):
    """``cli run --dataset rosbag --device cpu`` end to end (as
    tests/test_export_cli.py::test_cli_rosbag drives the JAX CLI): six
    frames, a finite TUM trajectory, the JSON line, the packer report."""
    bag = str(tmp_path / "seq.bag")
    _write_synthetic_bag(bag)
    out = str(tmp_path / "out")
    cli.main(["run", "--dataset", "rosbag", "--root", bag, "--cloud-topic", "/points_raw",
              "--imu-topic", "/imu_raw", "--out", out, "--device", "cpu"])
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert line["frames"] == 6 and line["out"] == out
    packer = [json.loads(x) for x in captured.err.splitlines() if x.startswith('{"packer"')]
    assert packer == [{"packer": {"native": 5}}]
    tum = np.loadtxt(os.path.join(out, "trajectory_tum.txt"))
    assert tum.shape == (6, 8) and np.isfinite(tum).all()


def test_cli_datasets_need_a_root(tmp_path):
    for ds in ("kitti", "mulran", "rosbag"):
        with pytest.raises(SystemExit, match="--root"):
            cli.main(["run", "--dataset", ds, "--out", str(tmp_path), "--device", "cpu"])


def test_cli_run_kitti_matches_jax_reader_frames(tmp_path, rng):
    """``cli run --dataset kitti`` reads the drive it is pointed at: as many
    frames as the JAX reader finds there."""
    root = _write_kitti_drive(str(tmp_path / "drive"), n_frames=3, n_pts=400, rng=rng)
    out = str(tmp_path / "out")
    cli.main(["run", "--dataset", "kitti", "--root", root, "--out", out, "--device", "cpu"])
    tum = np.loadtxt(os.path.join(out, "trajectory_tum.txt"))
    assert tum.shape[0] == len(jkitti.KittiRawDataset(root)) == 3
