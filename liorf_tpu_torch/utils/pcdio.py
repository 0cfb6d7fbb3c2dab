"""Minimal PCD (Point Cloud Data) binary I/O.

Covers the reference's map-export format (``pcl::io::savePCDFileBinary``,
``mapOptmization.cpp:392-424``): XYZI clouds and the
6-DoF "transformations" cloud (x y z intensity roll pitch yaw time).
A copy of ``liorf_tpu/utils/pcdio.py`` (numpy only).
"""

from __future__ import annotations

import numpy as np

_DTYPES = {"F": {4: "f4", 8: "f8"}, "I": {1: "i1", 2: "i2", 4: "i4"}, "U": {1: "u1", 2: "u2", 4: "u4"}}


def save_pcd(path: str, fields: dict[str, np.ndarray]):
    """Write a binary PCD with the given named float32 fields (equal length)."""
    names = list(fields)
    n = len(next(iter(fields.values())))
    arrs = [np.asarray(fields[k], np.float32).reshape(n) for k in names]
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(names)}\n"
        f"SIZE {' '.join(['4'] * len(names))}\n"
        f"TYPE {' '.join(['F'] * len(names))}\n"
        f"COUNT {' '.join(['1'] * len(names))}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA binary\n"
    )
    data = np.stack(arrs, axis=1).astype("<f4")
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(data.tobytes())


def load_pcd(path: str) -> dict[str, np.ndarray]:
    """Read binary or ascii PCD -> {field: [N] float array}."""
    with open(path, "rb") as f:
        raw = f.read()
    # parse header
    lines = []
    pos = 0
    while True:
        nl = raw.index(b"\n", pos)
        line = raw[pos:nl].decode()
        pos = nl + 1
        lines.append(line)
        if line.startswith("DATA"):
            break
    hdr = {l.split()[0]: l.split()[1:] for l in lines if l and not l.startswith("#")}
    names = hdr["FIELDS"]
    sizes = [int(s) for s in hdr["SIZE"]]
    typs = hdr["TYPE"]
    n = int(hdr["POINTS"][0])
    mode = hdr["DATA"][0]
    np_dtype = np.dtype(
        [(nm, "<" + _DTYPES[t][s]) for nm, t, s in zip(names, typs, sizes)]
    )
    if mode == "binary":
        body = np.frombuffer(raw, dtype=np_dtype, count=n, offset=pos)
    elif mode == "ascii":
        body = np.loadtxt(
            [l for l in raw[pos:].decode().splitlines() if l.strip()],
            dtype=np.float64,
        ).reshape(n, len(names))
        return {nm: body[:, i] for i, nm in enumerate(names)}
    else:
        raise ValueError(f"unsupported PCD DATA mode {mode}")
    return {nm: np.asarray(body[nm]) for nm in names}
