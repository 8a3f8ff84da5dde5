"""Port parity, mesh container: the `Mesh` and its OBJ / GLB / PLY files,
`comfy3d_tpu_torch` against `comfy3d_tpu` on the same numpy inputs."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = pytest.mark.heavy

import numpy as np
import torch

from comfy3d_tpu.core import mesh as jmesh
from comfy3d_tpu.core.io import glb as jglb
from comfy3d_tpu.core.io import obj as jobj
from comfy3d_tpu.core.io import ply as jply

from comfy3d_tpu_torch.core import io as tio
from comfy3d_tpu_torch.core import mesh as tmesh


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# --------------------------------------------------------------- mesh
def _mesh_arrays():
    rng = np.random.RandomState(0)
    v = rng.randn(40, 3).astype(np.float32)
    f = rng.randint(0, 40, (60, 3)).astype(np.int32)
    vc = rng.rand(40, 3).astype(np.float32)
    return v, f, vc


def test_mesh_ops_match_jax():
    v, f, vc = _mesh_arrays()
    ref = jmesh.Mesh(v=v, f=f, vc=vc)
    port = tmesh.Mesh(v=v, f=f, vc=vc)
    for op in (lambda m: m.auto_size(), lambda m: m.auto_normal(),
               lambda m: m.flip_faces(), lambda m: m.switch_axis("+y-z+x"),
               lambda m: m.switch_axis("-x+y+z").auto_normal()):
        a, b = op(ref), op(port)
        for name in ("v", "f", "vn", "fn", "vc"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None), name
            if x is not None:
                np.testing.assert_array_equal(y, x, err_msg=name)
    np.testing.assert_array_equal(tmesh.vertex_normals_np(v, f),
                                  jmesh.vertex_normals_np(v, f))
    for a, b in zip(port.convert_to_pointcloud(),
                    ref.convert_to_pointcloud()):
        np.testing.assert_array_equal(a, b)
    dev = port.auto_normal().device_arrays(device="cpu")
    jdev = ref.auto_normal().device_arrays()
    assert sorted(dev) == sorted(jdev)
    for k in dev:
        assert dev[k].device.type == "cpu", k
        np.testing.assert_array_equal(_np(dev[k]), np.asarray(jdev[k]),
                                      err_msg=k)


@pytest.mark.parametrize("ext", [".obj", ".glb", ".ply"])
def test_mesh_files_are_byte_identical_to_jax(tmp_path, ext):
    """One mesh written by both packages gives the same bytes; each reads
    the other's file back to the same arrays."""
    v, f, vc = _mesh_arrays()
    vn = jmesh.vertex_normals_np(v, f)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    a, b = tmp_path / "jax" / f"m{ext}", tmp_path / "port" / f"m{ext}"
    # each its own arrays: the JAX package's GLB writer normalises the
    # mesh's normals in place
    jmesh.Mesh(v=v.copy(), f=f.copy(), vn=vn.copy(), fn=f.copy(),
               vc=vc.copy()).write(str(a))
    port = tmesh.Mesh(v=v, f=f, vn=vn, fn=f, vc=vc)
    port.write(str(b))
    assert a.read_bytes() == b.read_bytes()
    assert port.vn is vn and np.array_equal(vn, jmesh.vertex_normals_np(v, f))
    ref = jmesh.Mesh.load(str(a))
    back = tmesh.Mesh.load(str(b))
    for name in ("v", "f", "vn", "vc"):
        x, y = getattr(ref, name), getattr(back, name)
        assert (x is None) == (y is None), name
        if x is not None:
            np.testing.assert_array_equal(y, x, err_msg=name)
    np.testing.assert_array_equal(back.f, f)
    np.testing.assert_allclose(back.v, v, atol=1e-6 if ext == ".obj" else 0)


def test_io_functions_match_jax(tmp_path):
    v, f, vc = _mesh_arrays()
    vt = np.random.RandomState(1).rand(40, 2).astype(np.float32)
    jobj.save_obj(str(tmp_path / "a.obj"), v, f, vt=vt, ft=f, vc=vc)
    tio.save_obj(str(tmp_path / "b.obj"), v, f, vt=vt, ft=f, vc=vc)
    assert (tmp_path / "a.obj").read_bytes() == \
        (tmp_path / "b.obj").read_bytes()
    ref, port = (jobj.load_obj(str(tmp_path / "a.obj")),
                 tio.load_obj(str(tmp_path / "b.obj")))
    jglb.save_glb(str(tmp_path / "a.glb"), v, f, vt=vt, ft=f)
    tio.save_glb(str(tmp_path / "b.glb"), v, f, vt=vt, ft=f)
    assert (tmp_path / "a.glb").read_bytes() == \
        (tmp_path / "b.glb").read_bytes()
    ref_g, port_g = (jglb.load_glb(str(tmp_path / "a.glb")),
                     tio.load_glb(str(tmp_path / "b.glb")))
    for r, p in ((ref, port), (ref_g, port_g)):
        for k in r:
            assert (r[k] is None) == (p[k] is None), k
            if r[k] is not None:
                np.testing.assert_array_equal(p[k], r[k], err_msg=k)
    jply.save_mesh_ply(str(tmp_path / "a.ply"), v, f, vc=vc)
    tio.save_mesh_ply(str(tmp_path / "b.ply"), v, f, vc=vc)
    for r, p in zip(jply.load_mesh_ply(str(tmp_path / "a.ply")),
                    tio.load_mesh_ply(str(tmp_path / "b.ply"))):
        np.testing.assert_array_equal(p, r)
