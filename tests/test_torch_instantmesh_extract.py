"""Port parity, InstantMesh `extract_mesh`: from one shared geometry
lattice (the mesh equal element for element), from each package's own
triplanes (within the lattices' difference), and the capacity ladder with
its memo, `comfy3d_tpu_torch` against `comfy3d_tpu` with the same
weights."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = [pytest.mark.heavy, pytest.mark.usefixtures("one_torch_thread")]

import jax
import jax.numpy as jnp
import numpy as np
import torch

from comfy3d_tpu.models.instantmesh import model as jm
from comfy3d_tpu.models.instantmesh.pipeline import \
    InstantMeshPipeline as JPipeline
from comfy3d_tpu.ops import tetra as jtet
from comfy3d_tpu.ops import volume as jvol

from comfy3d_tpu_torch import convert
from comfy3d_tpu_torch.models.instantmesh import model as tm
from comfy3d_tpu_torch.models.instantmesh import (InstantMeshConfig,
                                                  InstantMeshPipeline)
from comfy3d_tpu_torch.ops import tetra, volume

from tests.test_torch_common import (QUICK_XLA, _load, _np, _params,
                                     one_torch_thread)  # noqa: F401
from tests.test_torch_instantmesh import TINY, _inputs, init_all

RES = TINY["grid_res"] + 1          # extract_mesh's default lattice
# a triangle capacity ample for the tiny model's ~22,500 triangles; one
# compile of the JAX package's sweep and weld at it serves every test
CAP = 32768


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def pair():
    """Both pipelines with the same redrawn weights, the SDF head's bias
    moved so that the surface lies in the middle of the widest gap between
    neighbouring lattice values near the median (no lattice value near 0,
    so rounding decides no sign), each package's own triplanes of the same
    two views, and the JAX package's geometry lattice (SDF, deformation)."""
    cfg = jm.InstantMeshConfig(**TINY)
    params = _params(jm.InstantMesh(cfg), *map(jnp.asarray, _inputs()),
                     method=init_all, seed=4)
    imgs, cams, _, _ = _inputs(seed=3)
    jpipe = JPipeline(params, cfg)
    jplanes = jpipe.forward_planes(imgs, cams)[0]   # the bias moves no plane
    geometry = jax.jit(jpipe._geo_query, compiler_options=QUICK_XLA)
    lattice = jnp.asarray(jtet.grid_tets(RES)[0] * (2.1 * 0.5))
    sdf = np.sort(np.asarray(geometry((params, jplanes), lattice)[:, 0]))
    lo, hi = int(0.3 * sdf.size), int(0.7 * sdf.size)
    j = lo + int(np.argmax(np.diff(sdf[lo:hi + 1])))
    params["decoder"]["sdf_out"]["bias"] = (
        params["decoder"]["sdf_out"]["bias"]
        - np.float32(0.5 * (sdf[j] + sdf[j + 1])))
    pipe = InstantMeshPipeline(_load(
        tm.InstantMesh(InstantMeshConfig(**TINY)),
        convert.instantmesh_state_dict_from_flax(params)))
    return jpipe, pipe, jplanes, pipe.forward_planes(imgs, cams)[0], \
        np.asarray(geometry((params, jplanes), lattice)), np.asarray(lattice)


def _share(monkeypatch, geo):
    """Each package's geometry query (the `query_chunked` call over the
    whole lattice in `extract_mesh`) answers with `geo`; the colour queries
    run as they are, the JAX package's jitted (one compile, not one per
    eager op). Returns the geometry calls, by package."""
    calls = []

    def fixed(real, lib):
        def query(fn, *args, **kw):
            pts = args[-1] if lib is jnp else args[0]
            if pts.shape[0] != RES ** 3:
                return real(jax.jit(fn, compiler_options=QUICK_XLA)
                            if lib is jnp else fn, *args, **kw)
            calls.append(lib)
            return lib.asarray(geo) if lib is jnp else torch.tensor(geo)
        return query

    monkeypatch.setattr(jvol, "query_chunked",
                        fixed(jvol.query_chunked, jnp))
    monkeypatch.setattr(volume, "query_chunked",
                        fixed(volume.query_chunked, torch))
    return calls


@pytest.fixture(scope="module")
def jmesh(pair):
    """The JAX package's mesh from its own triplanes at the ample capacity,
    its geometry query answered by the package's jitted decode of the same
    lattice (`pair`'s grid; one compile, not one per eager op), colours
    from its own colour query."""
    jpipe, _, jplanes, _, jgeo, _ = pair
    with pytest.MonkeyPatch.context() as mp:
        calls = _share(mp, jgeo)
        ref = jpipe.extract_mesh(jplanes, max_tris=CAP)
    assert calls == [jnp] and ref.num_faces > 300
    return ref


def _count_rungs(monkeypatch):
    rungs = {"jax": 0, "port": 0}

    def counted(real, name):
        def sweep(*args, **kw):
            rungs[name] += 1
            return real(*args, **kw)
        return sweep

    monkeypatch.setattr(jtet, "marching_tets_deformed",
                        counted(jtet.marching_tets_deformed, "jax"))
    monkeypatch.setattr(tetra, "marching_tets_deformed",
                        counted(tetra.marching_tets_deformed, "port"))
    return rungs


def _assert_same_mesh(mesh, ref):
    for name in ("v", "f", "vn"):
        np.testing.assert_array_equal(getattr(mesh, name), getattr(ref, name),
                                      err_msg=name)
    assert (mesh.vc is None) == (ref.vc is None)
    if ref.vc is not None:
        # colours are uint8-quantized: equal, or one step apart where the
        # two packages' rgb straddle a rounding boundary
        assert np.abs(mesh.vc - ref.vc).max() <= 1 / 255 + 1e-7


def test_extract_mesh_from_one_geometry_lattice(pair, jmesh, monkeypatch):
    """Both packages' `extract_mesh` on one SDF + deformation lattice: the
    lattice, the deformation, the capacity and the sweep reach the mesh
    alike, which is equal element for element (colours within one uint8
    step)."""
    _, pipe, jplanes, _, jgeo, _ = pair
    calls = _share(monkeypatch, jgeo)
    mesh = pipe.extract_mesh(torch.tensor(np.asarray(jplanes)).permute(
        0, 3, 1, 2), max_tris=CAP)
    assert calls == [torch]
    _assert_same_mesh(mesh, jmesh)


def test_extract_mesh_from_each_packages_own_planes(pair, jmesh):
    """Each package from its own triplanes of the same views (the port
    through its own geometry query): the same triangles in the same order,
    each corner within what the two lattices' difference allows."""
    _, pipe, _, planes, jgeo, lattice = pair
    with torch.no_grad():
        sdf, deform = pipe.model.query_geometry(planes,
                                                torch.tensor(lattice))
    dsdf = np.abs(_np(sdf) - jgeo[:, 0]).max()
    ddef = np.abs(_np(deform) - jgeo[:, 1:]).max()
    gap = np.abs(jgeo[:, 0]).min()
    # no lattice value so near 0 that the two packages could differ in sign
    assert dsdf <= 1e-5 * np.abs(jgeo[:, 0]).max() and gap >= 100 * dsdf
    ref = jmesh
    mesh = pipe.extract_mesh(planes, max_tris=CAP)
    assert mesh.num_faces == ref.num_faces
    # a crossing point moves with its end points (≤ ddef) and along its
    # edge by ≤ 3δ/|va − vb| ≤ 1.5δ/gap of the edge (≤ √3 cells + 2 ddef)
    cell = 2.1 / (RES - 1)
    tol = 1e-6 + ddef + 1.5 * (np.sqrt(3) * cell + 2 * ddef) * dsdf / gap
    assert tol <= 1e-3, (tol, dsdf, ddef, gap)
    np.testing.assert_allclose(mesh.v[mesh.f], ref.v[ref.f], atol=tol,
                               rtol=0)
    # the weld's 1e-6 rounding can split a point in one package only
    assert abs(mesh.num_vertices - ref.num_vertices) <= \
        max(2, ref.num_vertices // 1000)


def test_capacity_ladder_and_memo_match_jax(pair, monkeypatch):
    """Half the ample capacity (fewer than the triangles) doubles once in
    both packages, to the same memoised capacity and mesh; the next call without `max_tris`
    starts from the memo and sweeps once; without a memo both start at
    max(262,144, 24·(res − 1)²)."""
    jpipe, pipe, jplanes, _, jgeo, _ = pair
    shared = torch.tensor(np.asarray(jplanes)).permute(0, 3, 1, 2)
    _share(monkeypatch, jgeo)
    kw = dict(with_color=False)
    jpipe._cap_memo, pipe._cap_memo = {}, {}
    rungs = _count_rungs(monkeypatch)
    ref = jpipe.extract_mesh(jplanes, max_tris=CAP // 2, **kw)
    mesh = pipe.extract_mesh(shared, max_tris=CAP // 2, **kw)
    assert rungs == {"jax": 2, "port": 2}
    assert pipe._cap_memo == jpipe._cap_memo == {RES: CAP}
    _assert_same_mesh(mesh, ref)
    assert mesh.num_faces > CAP // 2
    ref = jpipe.extract_mesh(jplanes, **kw)
    mesh = pipe.extract_mesh(shared, **kw)
    assert rungs == {"jax": 3, "port": 3}
    assert pipe._cap_memo == jpipe._cap_memo == {RES: CAP}
    _assert_same_mesh(mesh, ref)

    # the first rung's capacity without a memo, read where the sweep starts
    caps = []

    def stop(*args, max_tris, **kw):
        caps.append(max_tris)
        raise _Stop

    monkeypatch.setattr(jtet, "marching_tets_deformed", stop)
    monkeypatch.setattr(tetra, "marching_tets_deformed", stop)
    monkeypatch.setattr(jvol, "query_chunked",
                        lambda fn, ctx, pts, **kw: jnp.zeros((len(pts), 4)))
    monkeypatch.setattr(volume, "query_chunked",
                        lambda fn, pts, **kw: torch.zeros(len(pts), 4))
    for res in (RES, 106):
        for p, planes in ((jpipe, jplanes), (pipe, shared)):
            p._cap_memo = {}
            with pytest.raises(_Stop):
                p.extract_mesh(planes, resolution=res)
    assert caps == [262_144] * 2 + [24 * 105 ** 2] * 2
