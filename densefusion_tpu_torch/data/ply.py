"""Minimal ASCII PLY reader/writer (counterpart of
``densefusion_tpu/data/ply.py``): LineMOD's model vertices, and point
clouds written for visual checks."""

from __future__ import annotations

import numpy as np


def read_ply_vertices(path: str) -> np.ndarray:
    """Read vertex xyz coordinates from an ASCII PLY file -> (N, 3) float32."""
    with open(path, "r") as f:
        line = f.readline().strip()
        if line != "ply":
            raise ValueError(f"{path}: not a PLY file (header {line!r})")
        n_vertices = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            line = line.strip()
            if line.startswith("element vertex"):
                n_vertices = int(line.split()[-1])
            elif line.startswith("format") and "ascii" not in line:
                raise ValueError(f"{path}: only ascii PLY supported ({line})")
            elif line == "end_header":
                break
        if n_vertices is None:
            raise ValueError(f"{path}: no vertex element")
        pts = np.empty((n_vertices, 3), np.float32)
        for i in range(n_vertices):
            pts[i] = np.asarray(f.readline().split()[:3], np.float32)
    return pts


def write_ply(path: str, points: np.ndarray,
              colors: np.ndarray | None = None) -> None:
    """Write an (N, 3) point cloud (optional (N, 3) uint8 colors) as ASCII
    PLY."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        if colors is None:
            for p in points:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")
        else:
            colors = np.asarray(colors, np.uint8).reshape(-1, 3)
            for p, c in zip(points, colors):
                f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")
