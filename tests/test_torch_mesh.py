"""PyTorch port: ``utils.mesh`` against ``mojosplat_tpu.utils.mesh``.

``marching_tetrahedra`` (a numpy copy) must give the reference's vertices
and faces bit for bit on the sphere field, a masked field and an empty
one; the mesh writers must write the same bytes. ``tsdf_fuse`` (torch on
the cameras' device) is held to the reference's on identical depth and
alpha maps and cameras: the TSDF within 1e-5 where both weights agree, and
the weights equal on all but a counted handful of voxels (a 1e-7
difference in a bilinear sample can flip the ``valid`` test of a voxel on
a threshold). And tests/test_mesh.py's end-to-end surfel-sphere
reconstruction, through the port on both routes, under that test's bounds.
"""

import numpy as np
import pytest

from mojosplat_tpu import Camera as JCamera
from mojosplat_tpu import look_at as jlook_at
from mojosplat_tpu.utils import mesh as jmesh
from mojosplat_tpu_torch.convert import camera_from_numpy
from mojosplat_tpu_torch.utils import mesh
from torch_scene_tools_cases import (
    SPHERE_MEDIAN_VOXELS,
    SPHERE_P90_VOXELS,
    SPHERE_R,
    reconstruct_sphere,
    sphere_sdf,
)

# Voxels whose weight may differ between the packages: threshold flips.
TSDF_ATOL, WEIGHT_MAX_FLIPS = 1e-5, 16


def mt_case(name):
    sdf, origin, spacing = sphere_sdf(n=24)
    if name == "sphere":
        return dict(sdf=sdf, origin=origin, spacing=spacing)
    if name == "masked":
        mask = np.ones(sdf.shape, bool)
        mask[:, :, :9] = False  # a cut through the sphere
        mask[3, 12, 15] = False
        return dict(sdf=sdf, origin=origin, spacing=spacing, mask=mask)
    return dict(sdf=sdf + 10.0)  # all outside: empty


@pytest.mark.parametrize("case", ["sphere", "masked", "empty"])
def test_marching_tetrahedra_bit_equal(case):
    kw = mt_case(case)
    v_want, f_want = jmesh.marching_tetrahedra(**kw)
    v_got, f_got = mesh.marching_tetrahedra(**kw)
    assert v_got.dtype == v_want.dtype and f_got.dtype == f_want.dtype
    np.testing.assert_array_equal(v_got, v_want)
    np.testing.assert_array_equal(f_got, f_want)
    assert (len(f_got) > 0) == (case != "empty")


@pytest.mark.parametrize("fmt", ["ply", "obj"])
def test_mesh_writers_byte_equal(tmp_path, fmt):
    sdf, origin, spacing = sphere_sdf(n=12)
    verts, faces = mesh.marching_tetrahedra(sdf, origin=origin, spacing=spacing)
    write = {"ply": (jmesh.save_mesh_ply, mesh.save_mesh_ply),
             "obj": (jmesh.save_mesh_obj, mesh.save_mesh_obj)}[fmt]
    write[0](str(tmp_path / f"want.{fmt}"), verts, faces)
    write[1](str(tmp_path / f"got.{fmt}"), verts, faces)
    assert (tmp_path / f"got.{fmt}").read_bytes() == (tmp_path / f"want.{fmt}").read_bytes()


def sphere_maps(R, T, H, W, f, rng):
    """Camera-frame z of each pixel ray's hit on the sphere of radius
    SPHERE_R at the origin (0 on a miss), and an alpha of 1 on a hit, 0 on
    a miss, with seeded noise."""
    v, u = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5, indexing="ij")
    d_cam = np.stack([(u - W / 2) / f, (v - H / 2) / f, np.ones_like(u)], -1)
    d_world = d_cam @ R  # R^T d, row-wise
    o = -R.T @ T  # camera centre
    b = d_world @ o
    a = np.sum(d_world**2, -1)
    c = o @ o - SPHERE_R**2
    disc = b * b - a * c
    hit = disc > 0
    t = (-b - np.sqrt(np.maximum(disc, 0.0))) / a  # along d_cam, whose z is 1
    depth = np.where(hit, t, 0.0).astype(np.float32)
    alpha = np.clip(hit + rng.normal(0, 0.05, hit.shape), 0, 1).astype(np.float32)
    return depth, alpha


def test_tsdf_fuse_matches_reference():
    rng = np.random.default_rng(5)
    H, W, f, res = 40, 48, 40.0, 40
    jcams, tcams, depths, alphas = [], [], [], []
    for el, az in ((0.3, 0.0), (-0.2, 1.7), (0.5, 3.5), (0.0, 5.0)):
        eye = 2.5 * np.array([np.sin(az) * np.cos(el), np.sin(el), np.cos(az) * np.cos(el)])
        R, T = (np.asarray(x) for x in jlook_at(eye=eye.astype(np.float32),
                                                 target=np.zeros(3, np.float32),
                                                 up=np.array([0.0, 1.0, 0.0], np.float32)))
        fields = dict(R=R, T=T, H=H, W=W, fx=f, fy=f, cx=W / 2, cy=H / 2)
        jcams.append(JCamera.create(**fields))
        tcams.append(camera_from_numpy(dict(fields, near=0.1, far=100.0), "cpu"))
        d, a = sphere_maps(R.astype(np.float64), T.astype(np.float64), H, W, f, rng)
        depths.append(d)
        alphas.append(a)
    bounds = ((-1.1,) * 3, (1.1,) * 3)
    t_want, w_want, o_want, s_want = jmesh.tsdf_fuse(depths, alphas, jcams, bounds, res)
    t_got, w_got, o_got, s_got = mesh.tsdf_fuse(depths, alphas, tcams, bounds, res)
    np.testing.assert_array_equal(o_got, o_want)
    np.testing.assert_array_equal(s_got, s_want)
    assert t_got.shape == t_want.shape == (res,) * 3 and t_got.dtype == np.float32
    flips = int((w_got != w_want).sum())
    assert flips <= WEIGHT_MAX_FLIPS, f"{flips} voxels' weights differ"
    assert (w_want > 0).mean() > 0.1  # the maps observe a good part of the grid
    same = w_got == w_want
    np.testing.assert_allclose(t_got[same], t_want[same], rtol=0, atol=TSDF_ATOL)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_end_to_end_sphere_reconstruction(impl):
    """tests/test_mesh.py's reconstruction through the port (the "cuda"
    route runs the kernels' plain versions on the CPU)."""
    out = reconstruct_sphere(impl, "cpu")
    assert out["observed"] > 0.2
    assert len(out["verts"]) > 500 and len(out["faces"]) > 1000
    assert out["median_voxels"] < SPHERE_MEDIAN_VOXELS
    assert out["p90_voxels"] < SPHERE_P90_VOXELS
