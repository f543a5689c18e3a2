"""Map export: coloured point clouds and voxel-surface meshes to PLY — port
of ``ground_fusion2_tpu/mesh/export.py`` on the port's voxel map.

The LIO voxel map dumps as a point cloud or as a blocky voxel-surface mesh
(the exposed faces of occupied voxels), both standard ASCII PLY. Host numpy:
the map's codes and origin are read back once.
"""

from __future__ import annotations

import numpy as np

from ..lio import voxel_map as vm


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def export_pointcloud_ply(path: str, pts, colors=None):
    pts = _host(pts).astype(np.float32)
    n = pts.shape[0]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        colors = None if colors is None else _host(colors)
        for i in range(n):
            line = f"{pts[i, 0]:.4f} {pts[i, 1]:.4f} {pts[i, 2]:.4f}"
            if colors is not None:
                c = colors[i].astype(int)
                line += f" {c[0]} {c[1]} {c[2]}"
            f.write(line + "\n")


# the corners of each face, by the direction of its neighbour
FACE = {
    (+1, 0, 0): [(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1)],
    (-1, 0, 0): [(0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0)],
    (0, +1, 0): [(0, 1, 0), (0, 1, 1), (1, 1, 1), (1, 1, 0)],
    (0, -1, 0): [(0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)],
    (0, 0, +1): [(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)],
    (0, 0, -1): [(0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 0, 0)],
}


def _unpack(code):
    m = (1 << vm.BITS) - 1
    return ((code & m) - vm.HALF, ((code >> vm.BITS) & m) - vm.HALF,
            ((code >> (2 * vm.BITS)) & m) - vm.HALF)


def _pack(ix, iy, iz):
    return ((ix + vm.HALF) | ((iy + vm.HALF) << vm.BITS)
            | ((iz + vm.HALF) << (2 * vm.BITS)))


def voxel_surface_mesh(map_: vm.VoxelMap, cfg):
    """Exposed faces of occupied voxels -> (vertices [V, 3], faces [F, 4]),
    in the JAX package's order (voxels as a Python set of codes iterates
    them, faces by direction, corners shared)."""
    codes = _host(map_.code)
    occ = set(codes[codes != vm.INVALID].tolist())
    vs = cfg.voxel_size
    origin = _host(map_.origin)
    verts: list = []
    faces: list = []
    vid: dict = {}

    def vertex(ix, iy, iz):
        key = (ix, iy, iz)
        if key not in vid:
            vid[key] = len(verts)
            verts.append(origin + np.array([ix, iy, iz]) * vs)
        return vid[key]

    for code in occ:
        ix, iy, iz = _unpack(code)
        for (dx, dy, dz), corners in FACE.items():
            if _pack(ix + dx, iy + dy, iz + dz) in occ:
                continue  # neighbour occupied: face hidden
            faces.append([vertex(ix + cx, iy + cy, iz + cz)
                          for cx, cy, cz in corners])
    return (np.asarray(verts, np.float32).reshape(-1, 3),
            np.asarray(faces, np.int64).reshape(-1, 4))


def export_voxel_mesh_ply(path: str, map_: vm.VoxelMap, cfg):
    verts, faces = voxel_surface_mesh(map_, cfg)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {verts.shape[0]}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {faces.shape[0]}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v in verts:
            f.write(f"{v[0]:.4f} {v[1]:.4f} {v[2]:.4f}\n")
        for fc in faces:
            f.write(f"4 {fc[0]} {fc[1]} {fc[2]} {fc[3]}\n")
    return verts.shape[0], faces.shape[0]
