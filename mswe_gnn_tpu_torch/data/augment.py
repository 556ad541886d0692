"""Data augmentation: mesh / feature rotation (port of
mswe_gnn_tpu/data/augment.py).

The reference rotation augmentation (reference
utils/dataset.py:640-668, database/graph_creation.py:984-1002): rotate the
mesh geometry and every direction-valued feature (slopes, relative edge
distances) by the same rotation matrix; scalar features are invariant.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from mswe_gnn_tpu_torch.data.dataset import ProcessedSimulation, SimulationRecord
from mswe_gnn_tpu_torch.data.meshing import Mesh, MultiscaleMesh


def rotation_matrix(angle_deg: float) -> np.ndarray:
    a = np.deg2rad(angle_deg)
    return np.asarray([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])


def rotate_mesh(mesh: Mesh, angle_deg: float) -> Mesh:
    """Rotate a mesh's geometry around the origin
    (reference graph_creation.py:984-1002)."""
    R = rotation_matrix(angle_deg)
    return dataclasses.replace(
        mesh,
        face_xy=mesh.face_xy @ R.T,
        face_relative_distance=mesh.face_relative_distance @ R.T,
    )


def rotate_record(rec: SimulationRecord, angle_deg: float) -> SimulationRecord:
    """Rotate a whole simulation record: geometry + velocity vectors."""
    R = rotation_matrix(angle_deg)
    mesh = MultiscaleMesh(
        meshes=[rotate_mesh(m, angle_deg) for m in rec.mesh.meshes],
        node_ptr=rec.mesh.node_ptr, edge_ptr=rec.mesh.edge_ptr,
        intra_edge_ptr=rec.mesh.intra_edge_ptr,
        intra_edge_index=rec.mesh.intra_edge_index, ghosts=rec.mesh.ghosts)
    v = np.stack([rec.vx, rec.vy])                 # [2, N, T]
    v_rot = np.einsum("ij,jnt->int", R, v)
    return dataclasses.replace(rec, mesh=mesh, vx=v_rot[0], vy=v_rot[1])


def rotate_processed(proc: ProcessedSimulation, angle_deg: float,
                     selected_node_features: Dict[str, bool],
                     selected_edge_features: Dict[str, bool],
                     ) -> ProcessedSimulation:
    """Rotate direction-valued columns of an already-processed simulation
    (reference utils/dataset.py:640-668).

    Rotates ``slopes`` (first two node-feature columns when selected) and
    ``edge_relative_distance`` (two edge-feature columns after edge_length
    when selected); |q| is rotation-invariant (a magnitude).
    """
    R = rotation_matrix(angle_deg)
    x = proc.x_static.copy()
    ea = proc.edge_attr.copy()
    if selected_node_features.get("slopes"):
        x[:, :2] = x[:, :2] @ R.T
    if selected_edge_features.get("edge_relative_distance"):
        off = int(bool(selected_edge_features.get("edge_length")))
        ea[:, off: off + 2] = ea[:, off: off + 2] @ R.T
    return dataclasses.replace(proc, x_static=x, edge_attr=ea)
