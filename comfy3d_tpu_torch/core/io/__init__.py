"""Mesh and splat file I/O (obj, ply, glb; GS-PLY for splats).

Port of `comfy3d_tpu/core/io/__init__.py`: the same load/save dispatch by
extension, on the host."""

from __future__ import annotations

import os

from .glb import load_glb, save_glb
from .obj import load_obj, save_obj
from .ply import (load_gs_ply, load_mesh_ply, read_ply, save_gs_ply,
                  save_mesh_ply, write_ply)

SUPPORTED_MESH_EXTENSIONS = (".obj", ".ply", ".glb", ".gltf")
SUPPORTED_3DGS_EXTENSIONS = (".ply",)

__all__ = ["load_glb", "load_gs_ply", "load_mesh", "load_mesh_ply",
           "load_obj", "read_ply", "save_glb", "save_gs_ply", "save_mesh",
           "save_mesh_ply", "save_obj", "write_ply",
           "SUPPORTED_MESH_EXTENSIONS", "SUPPORTED_3DGS_EXTENSIONS"]


def load_mesh(path: str):
    from ..mesh import Mesh
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        d = load_obj(path)
        return Mesh(v=d["v"], f=d["f"], vt=d["vt"], ft=d["ft"],
                    vn=d["vn"], fn=d["fn"], vc=d["vc"], albedo=d["albedo"])
    if ext == ".ply":
        v, f, vn, vc = load_mesh_ply(path)
        if f is None:
            raise ValueError(f"{path}: PLY has no faces; use load_gs_ply or "
                             "point-cloud loaders for splat/point PLYs")
        return Mesh(v=v, f=f, vn=vn, fn=f.copy() if vn is not None else None,
                    vc=vc)
    if ext in (".glb", ".gltf"):
        d = load_glb(path)
        return Mesh(v=d["v"], f=d["f"], vt=d["vt"], ft=d["ft"], vn=d["vn"],
                    fn=d["f"].copy() if d["vn"] is not None else None,
                    albedo=d["albedo"],
                    metallic_roughness=d["metallic_roughness"])
    raise ValueError(f"unsupported mesh extension: {ext}")


def save_mesh(mesh, path: str) -> None:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        save_obj(path, mesh.v, mesh.f, vt=mesh.vt, ft=mesh.ft, vn=mesh.vn,
                 fn=mesh.fn, vc=mesh.vc, albedo=mesh.albedo)
    elif ext == ".ply":
        save_mesh_ply(path, mesh.v, mesh.f, vn=mesh.vn, vc=mesh.vc)
    elif ext in (".glb", ".gltf"):
        save_glb(path, mesh.v, mesh.f, vt=mesh.vt, ft=mesh.ft, vn=mesh.vn,
                 albedo=mesh.albedo,
                 metallic_roughness=mesh.metallic_roughness)
    else:
        raise ValueError(f"unsupported mesh extension: {ext}")
