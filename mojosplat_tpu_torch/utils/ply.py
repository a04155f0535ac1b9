"""3D-Gaussian-Splatting PLY scene IO (the standard interchange format).

Port of ``mojosplat_tpu.utils.ply`` (numpy only), reading and writing the
same files. The INRIA layout:

    x y z nx ny nz f_dc_{0..2} f_rest_{0..3(K-1)-1} opacity scale_{0..2}
    rot_{0..3}

with opacity stored as a logit (``opacities_raw``), scales in log space,
rot as wxyz quaternions, f_dc the SH band-0 coefficients and f_rest the
remaining bands channel-major (all R coefficients, then G, then B). 2DGS
surfel scenes carry ``scale_0..1`` only.

Parsing and writing use the native C runtime (``native/``) when it builds
and the pure-numpy versions below otherwise; both give identical arrays
and files.
"""

from __future__ import annotations

import numpy as np

from ..native import get_native
from ..ops.sh import _C0, num_sh_bases


def _read_ply_python(path: str):
    """Pure-Python binary-PLY reader: (names, n_vertex, float32 blob)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        names: list[str] = []
        n_vertex = -1
        in_vertex = False
        fmt_ok = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            parts = line.decode("ascii", "replace").split()
            if not parts or parts[0] == "comment":
                continue
            if parts[0] == "format":
                if parts[1] != "binary_little_endian":
                    raise ValueError(f"{path}: only binary_little_endian supported")
                fmt_ok = True
            elif parts[0] == "element":
                if parts[1] == "vertex":
                    n_vertex = int(parts[2])
                    in_vertex = True
                elif int(parts[2]) > 0:
                    raise ValueError(f"{path}: unsupported element {parts[1]}")
                else:
                    in_vertex = False
            elif parts[0] == "property":
                if in_vertex:
                    if parts[1] != "float":
                        raise ValueError(f"{path}: only float properties supported")
                    names.append(parts[2])
            elif parts[0] == "end_header":
                break
        if not fmt_ok or n_vertex < 0 or not names:
            raise ValueError(f"{path}: malformed PLY header")
        blob = f.read(n_vertex * len(names) * 4)
        if len(blob) != n_vertex * len(names) * 4:
            raise ValueError(f"{path}: truncated payload")
    return names, n_vertex, blob


def _write_ply_python(path: str, names: list[str], n: int, blob: bytes) -> None:
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for nm in names:
            f.write(f"property float {nm}\n".encode())
        f.write(b"end_header\n")
        f.write(blob)


def _read_ply(path: str):
    native = get_native()
    if native is not None:
        return native.load_ply(path)
    return _read_ply_python(path)


def load_gaussian_ply(path: str) -> dict:
    """Load a 3DGS (or 2DGS) scene as the raw parameter dict: means3d
    (N, 3), scales (N, 3) or (N, 2) log, quats (N, 4) wxyz, opacities_raw
    (N,), features (N, K, 3) SH coefficients; float32 numpy arrays."""
    names, n, blob = _read_ply(path)
    table = np.frombuffer(blob, "<f4").reshape(n, len(names))
    col = {nm: i for i, nm in enumerate(names)}

    def grab(prefix, count):
        return table[:, [col[f"{prefix}{i}"] for i in range(count)]]

    for req in ("x", "y", "z", "opacity", "f_dc_0", "scale_0", "rot_0"):
        if req not in col:
            raise ValueError(f"{path}: missing property {req!r}")

    means3d = table[:, [col["x"], col["y"], col["z"]]]
    n_rest = sum(1 for nm in names if nm.startswith("f_rest_"))
    if n_rest % 3 != 0:
        raise ValueError(f"{path}: f_rest count {n_rest} not divisible by 3")
    k_rest = n_rest // 3
    K = k_rest + 1
    deg = int(round(K**0.5)) - 1
    if num_sh_bases(max(deg, 0)) != K:
        raise ValueError(f"{path}: {K} SH bases is not a complete degree")

    features = np.zeros((n, K, 3), np.float32)
    features[:, 0, :] = grab("f_dc_", 3)
    if k_rest:
        rest = grab("f_rest_", n_rest)  # channel-major (N, 3 (K - 1))
        features[:, 1:, :] = rest.reshape(n, 3, k_rest).transpose(0, 2, 1)

    n_scales = sum(1 for nm in names if nm.startswith("scale_"))
    return dict(
        means3d=np.ascontiguousarray(means3d),
        scales=np.ascontiguousarray(grab("scale_", n_scales)),
        quats=np.ascontiguousarray(grab("rot_", 4)),
        opacities_raw=np.ascontiguousarray(table[:, col["opacity"]]),
        features=features,
    )


def save_gaussian_ply(path: str, params: dict) -> None:
    """Write the raw parameter dict (numpy arrays or tensors) as a PLY.

    (N, 2) scales (2DGS surfels) write ``scale_0..1``, (N, 3) the 3DGS
    ``scale_0..2``; (N, 3) RGB features are written as band-0 SH."""
    def as_np(v):
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        return np.asarray(v, np.float32)

    means3d = as_np(params["means3d"])
    scales = as_np(params["scales"])
    quats = as_np(params["quats"])
    opac = as_np(params["opacities_raw"])
    feats = as_np(params["features"])
    if feats.ndim == 2:  # plain RGB -> band-0 SH
        feats = ((feats - np.float32(0.5)) / np.float32(_C0))[:, None, :]
    n, K, _ = feats.shape
    k_rest = K - 1

    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(3 * k_rest)]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(scales.shape[1])]
    names += [f"rot_{i}" for i in range(4)]

    cols = [
        means3d,
        np.zeros((n, 3), np.float32),  # normals, by convention zero
        feats[:, 0, :],
        feats[:, 1:, :].transpose(0, 2, 1).reshape(n, 3 * k_rest),
        opac[:, None],
        scales,
        quats,
    ]
    table = np.ascontiguousarray(np.concatenate(cols, axis=1), "<f4")
    assert table.shape == (n, len(names))
    native = get_native()
    if native is not None:
        native.save_ply(path, names, n, table.tobytes())
    else:
        _write_ply_python(path, names, n, table.tobytes())
