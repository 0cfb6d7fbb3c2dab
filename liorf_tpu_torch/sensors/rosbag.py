"""ROS1 bag (v2.0 format) reader — no ROS required.

The reference consumes sensor data via `rosbag play`; datasets like M2DGR
and UrbanNav are distributed as .bag files. This module reads them
directly: the container format (records / chunks / connections, bz2
compression) plus deserializers for the message types the reference
subscribes to (``sensor_msgs/PointCloud2``, ``sensor_msgs/Imu``,
``sensor_msgs/NavSatFix``, ``nav_msgs/Odometry``).

A native C++ chunk scanner (`liorf_tpu_torch.native`) accelerates the container
walk when built; this pure-Python implementation is the always-available
fallback and the reference for its tests.
"""

from __future__ import annotations

import bz2
import os
import struct
from dataclasses import dataclass

import numpy as np

from .types import GpsFix, ImuSample, LidarScan

_MAGIC = b"#ROSBAG V2.0\n"

OP_MESSAGE = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07


def _parse_header(buf: bytes) -> dict[str, bytes]:
    fields = {}
    pos = 0
    while pos < len(buf):
        (flen,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        field = buf[pos : pos + flen]
        pos += flen
        eq = field.index(b"=")
        fields[field[:eq].decode()] = field[eq + 1 :]
    return fields


def _read_record(data: bytes, pos: int):
    (hlen,) = struct.unpack_from("<I", data, pos)
    pos += 4
    header = _parse_header(data[pos : pos + hlen])
    pos += hlen
    (dlen,) = struct.unpack_from("<I", data, pos)
    pos += 4
    payload = data[pos : pos + dlen]
    pos += dlen
    return header, payload, pos


@dataclass
class Connection:
    cid: int
    topic: str
    datatype: str
    md5sum: str


class BagReader:
    """Iterate (topic, datatype, stamp_sec, raw_bytes) in chunk order."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.data = f.read()
        if not self.data.startswith(_MAGIC):
            raise ValueError("not a ROSBAG V2.0 file")
        self.connections: dict[int, Connection] = {}

    def _register_connection(self, header, payload):
        cid = struct.unpack("<I", header["conn"])[0]
        sub = _parse_header(payload)
        self.connections[cid] = Connection(
            cid=cid,
            topic=header.get("topic", b"").decode(),
            datatype=sub.get("type", b"").decode(),
            md5sum=sub.get("md5sum", b"").decode(),
        )

    def messages(self):
        pos = len(_MAGIC)
        data = self.data
        n = len(data)
        while pos < n:
            header, payload, pos = _read_record(data, pos)
            op = header["op"][0]
            if op == OP_CONNECTION:
                self._register_connection(header, payload)
            elif op == OP_CHUNK:
                comp = header.get("compression", b"none").decode()
                if comp == "bz2":
                    chunk = None
                    size = header.get("size")
                    if size is not None:
                        try:
                            from .. import native

                            chunk = native.bz2_decompress(
                                payload, struct.unpack("<I", size)[0]
                            )
                        except Exception:
                            chunk = None
                    if chunk is None:
                        chunk = bz2.decompress(payload)
                elif comp == "none":
                    chunk = payload
                elif comp == "lz4":
                    try:
                        import lz4.frame  # type: ignore

                        chunk = lz4.frame.decompress(payload)
                    except ImportError as e:  # pragma: no cover
                        raise RuntimeError("lz4-compressed bag; lz4 unavailable") from e
                else:  # pragma: no cover
                    raise ValueError(f"unknown chunk compression {comp}")
                cpos = 0
                while cpos < len(chunk):
                    ch, cpayload, cpos = _read_record(chunk, cpos)
                    cop = ch["op"][0]
                    if cop == OP_CONNECTION:
                        self._register_connection(ch, cpayload)
                    elif cop == OP_MESSAGE:
                        cid = struct.unpack("<I", ch["conn"])[0]
                        secs, nsecs = struct.unpack("<II", ch["time"])
                        conn = self.connections.get(cid)
                        if conn is not None:
                            yield conn.topic, conn.datatype, secs + nsecs * 1e-9, cpayload


# ---------------------------------------------------------------------------
# message deserializers (ROS serialization: little-endian, length-prefixed
# strings/arrays)
# ---------------------------------------------------------------------------

class _Cursor:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.buf, self.pos)
        self.pos += 4
        return v

    def u8(self) -> int:
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def f64(self, n=1):
        v = struct.unpack_from(f"<{n}d", self.buf, self.pos)
        self.pos += 8 * n
        return v if n > 1 else v[0]

    def string(self) -> str:
        n = self.u32()
        s = self.buf[self.pos : self.pos + n].decode(errors="replace")
        self.pos += n
        return s

    def time(self) -> float:
        secs = self.u32()
        nsecs = self.u32()
        return secs + nsecs * 1e-9

    def skip(self, n):
        self.pos += n


def parse_header_stamp(c: _Cursor) -> float:
    c.u32()  # seq
    t = c.time()
    c.string()  # frame_id
    return t


_PC2_DTYPES = {1: "i1", 2: "u1", 3: "i2", 4: "u2", 5: "i4", 6: "u4", 7: "f4", 8: "f8"}


def parse_pointcloud2(buf: bytes):
    """-> (stamp, {field: np.ndarray})."""
    c = _Cursor(buf)
    stamp = parse_header_stamp(c)
    height = c.u32()
    width = c.u32()
    n_fields = c.u32()
    fields = []
    for _ in range(n_fields):
        name = c.string()
        offset = c.u32()
        datatype = c.u8()
        count = c.u32()
        fields.append((name, offset, datatype, count))
    c.u8()  # is_bigendian
    point_step = c.u32()
    row_step = c.u32()
    data_len = c.u32()
    base = c.pos
    c.skip(data_len)
    n = height * width

    # native fast path: single-pass AoS -> SoA gather (float64 fields like
    # robosense per-point stamps keep the numpy path for full precision)
    if all(dt != 8 for _, _, dt, _ in fields):
        try:
            from .. import native

            cols = native.pc2_extract(
                c.buf[base : base + data_len], n, point_step,
                [(off, dt) for _, off, dt, _ in fields],
            )
        except Exception:
            cols = None
        if cols is not None:
            out = {}
            for i, (name, _, dt, _) in enumerate(fields):
                col = cols[i]
                if dt in (1, 2, 3, 4, 5, 6):
                    col = col.astype(np.int64 if dt in (5, 6) else np.int32)
                out[name] = col
            return stamp, out

    out = {}
    for name, offset, datatype, count in fields:
        dt = np.dtype("<" + _PC2_DTYPES[datatype])
        col = np.ndarray(
            (n,), dtype=dt, buffer=c.buf, offset=base + offset,
            strides=(point_step,),
        )
        out[name] = np.array(col)  # copy out of the strided view
    return stamp, out


def parse_imu(buf: bytes) -> ImuSample:
    c = _Cursor(buf)
    stamp = parse_header_stamp(c)
    qx, qy, qz, qw = c.f64(4)
    c.skip(9 * 8)  # orientation covariance
    wx, wy, wz = c.f64(3)
    c.skip(9 * 8)
    ax, ay, az = c.f64(3)
    return ImuSample(
        stamp=stamp,
        acc=np.asarray([ax, ay, az]),
        gyr=np.asarray([wx, wy, wz]),
        quat_wxyz=np.asarray([qw, qx, qy, qz]),
    )


def parse_navsatfix(buf: bytes) -> GpsFix:
    c = _Cursor(buf)
    stamp = parse_header_stamp(c)
    status = struct.unpack_from("<b", c.buf, c.pos)[0]
    c.skip(1)
    c.skip(2)  # service (uint16)
    lat, lon, alt = c.f64(3)
    cov = np.asarray(c.f64(9)).reshape(3, 3)
    return GpsFix(
        stamp=stamp, lat=lat, lon=lon, alt=alt,
        cov_xyz=np.diag(cov).copy(), status=status,
    )


# point schema adapters for the bag path -----------------------------------

def scan_from_pc2(stamp: float, fields: dict, sensor: str) -> LidarScan:
    """PointCloud2 fields -> normalized LidarScan via the per-sensor rules
    (imageProjection.cpp:216-278)."""
    from .types import from_mulran, from_ouster, from_robosense, from_velodyne

    xyz = np.stack([fields["x"], fields["y"], fields["z"]], axis=1).astype(np.float32)
    inten = fields.get("intensity", np.zeros(len(xyz), np.float32))
    ring = fields.get("ring", np.zeros(len(xyz), np.int32))
    finite = np.isfinite(xyz).all(axis=1)
    xyz, inten, ring = xyz[finite], np.asarray(inten)[finite], np.asarray(ring)[finite]
    if sensor in ("velodyne", "livox"):
        t = fields.get("time", np.zeros(len(finite), np.float32))
        return from_velodyne(stamp, xyz, inten, ring, np.asarray(t)[finite])
    if sensor == "ouster":
        return from_ouster(stamp, xyz, inten, ring, fields["t"][finite])
    if sensor == "mulran":
        return from_mulran(stamp, xyz, inten, ring, fields["t"][finite])
    if sensor == "robosense":
        return from_robosense(stamp, xyz, inten, ring, fields["timestamp"][finite])
    raise ValueError(f"unknown sensor {sensor}")


class RosbagDataset:
    """Stream a bag's scans/imu/gps for the pipeline (sorted by time)."""

    def __init__(self, path: str, cloud_topic: str, imu_topic: str,
                 gps_topic: str | None = None, sensor: str = "velodyne"):
        self.sensor = sensor
        self._scans: list[LidarScan] = []
        self._imu: list[ImuSample] = []
        self._gps: list[GpsFix] = []
        reader = BagReader(path)
        for topic, datatype, t, raw in reader.messages():
            if topic == cloud_topic and datatype.endswith("PointCloud2"):
                stamp, fields = parse_pointcloud2(raw)
                self._scans.append(scan_from_pc2(stamp, fields, sensor))
            elif topic == imu_topic and datatype.endswith("Imu"):
                self._imu.append(parse_imu(raw))
            elif gps_topic and topic == gps_topic and datatype.endswith("NavSatFix"):
                self._gps.append(parse_navsatfix(raw))
        self._scans.sort(key=lambda s: s.stamp)
        self._imu.sort(key=lambda s: s.stamp)
        self._gps.sort(key=lambda s: s.stamp)

    def __len__(self):
        return len(self._scans)

    def scan(self, i: int) -> LidarScan:
        return self._scans[i]

    def imu_stream(self):
        return self._imu

    def gps_stream(self):
        return self._gps
