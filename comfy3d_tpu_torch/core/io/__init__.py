"""Splat file I/O (GS-PLY)."""

from .ply import load_gs_ply, read_ply, save_gs_ply, write_ply

__all__ = ["load_gs_ply", "read_ply", "save_gs_ply", "write_ply"]
