"""The SMPL-X body model's linear blend skinning (PyTorch port of
motioncraft_tpu/ops/smplx_lbs.py).

The gesture protocol scores L1div and BeatAlign on LBS joints and the
facial metrics on mesh vertices of ``smplx.create(..., gender=
'NEUTRAL_2020', num_betas=300, num_expression_coeffs=100, use_pca=False)``.
This is that body model's forward pass:

  v_shaped = v_template + shapedirs @ betas + exprdirs @ expression
  J_rest   = J_regressor @ v_shaped
  v_posed  = v_shaped + posedirs @ vec(R_1..54 - I)
  G_j      = kinematic-chain global transforms from (R_j, J_rest)
  A_j      = G_j with the rest-pose correction (t - R @ j_rest)
  verts    = (W @ A) * v_posed (per-vertex skinning) + transl
  joints   = global joint positions (+ transl)

carried as (R, t) pairs rather than 4 x 4 matrices.  The model's buffers
stay on the host in f64, as the npz gives them; the first forward casts
them to f32 on the model's device (the card unless told), where the
skinning runs.

The asset (``SMPLX_NEUTRAL_2020.npz``) is not in the repository:
``find_model_path`` looks at an explicit path, ``$MOTIONCRAFT_SMPLX_MODEL``
and the checkout's data directory, and the gesture CLI falls back to the
approximate skeleton of ``ops/fk.py`` without it.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from .fk import SMPLX_PARENTS
from .rotation import axis_angle_to_matrix

NUM_JOINTS = 55
SHAPE_SPACE_DIM = 300  # the smplx package's constant: betas live in shapedirs[..., :300]
NUM_EXPR = 100


def find_model_path(path: Optional[str] = None) -> Optional[str]:
    """An SMPL-X neutral npz model, or None."""
    here = os.path.dirname(os.path.abspath(__file__))
    for cand in (path, os.environ.get("MOTIONCRAFT_SMPLX_MODEL"),
                 os.path.join(here, "..", "..", "data", "smplx_models", "smplx",
                              "SMPLX_NEUTRAL_2020.npz"),
                 os.path.join(here, "..", "..", "data", "SMPLX_NEUTRAL_2020.npz")):
        if cand and os.path.isfile(cand):
            return cand
    return None


class SMPLXModel:
    """SMPL-X LBS.  Pose parts are axis-angle, the hands full 45-d
    (use_pca=False), and the hand means are added inside
    (flat_hand_mean=False), as ``smplx.body_models.SMPLX.forward`` does."""

    def __init__(self, data: Dict[str, np.ndarray], num_betas: int = 300,
                 num_expression: int = NUM_EXPR, device="cuda"):
        self.device = torch.device(device)
        self.v_template = np.asarray(data["v_template"], np.float64)   # [V, 3]
        V = self.v_template.shape[0]
        shapedirs = np.asarray(data["shapedirs"], np.float64)          # [V, 3, 400]
        n_b = min(num_betas, SHAPE_SPACE_DIM, shapedirs.shape[-1])
        self.num_betas = n_b
        self.shapedirs = shapedirs[:, :, :n_b]
        if shapedirs.shape[-1] > SHAPE_SPACE_DIM:
            n_e = min(num_expression, shapedirs.shape[-1] - SHAPE_SPACE_DIM)
            self.exprdirs = shapedirs[:, :, SHAPE_SPACE_DIM:SHAPE_SPACE_DIM + n_e]
        else:
            self.exprdirs = np.zeros((V, 3, num_expression))
        self.num_expression = self.exprdirs.shape[-1]
        # posedirs [V, 3, 9 (J - 1)] in the npz, folded to [9 (J - 1), V * 3]
        self.posedirs = np.asarray(data["posedirs"], np.float64).reshape(V * 3, -1).T
        self.J_regressor = np.asarray(data["J_regressor"], np.float64)  # [55, V]
        self.lbs_weights = np.asarray(data["weights"], np.float64)      # [V, 55]
        if "kintree_table" in data:
            parents = np.asarray(data["kintree_table"])[0].astype(np.int64)
            parents[0] = -1
            self.parents = parents.astype(np.int32)
        else:
            self.parents = SMPLX_PARENTS
        # the full pose's mean: zeros but for the hands
        pose_mean = np.zeros(NUM_JOINTS * 3)
        if "hands_meanl" in data:
            pose_mean[75:120] = np.asarray(data["hands_meanl"], np.float64).ravel()
        if "hands_meanr" in data:
            pose_mean[120:165] = np.asarray(data["hands_meanr"], np.float64).ravel()
        self.pose_mean = pose_mean
        self.faces = np.asarray(data["f"]).astype(np.int32) if "f" in data else None
        self._bufs = None

    @classmethod
    def from_npz(cls, path: Optional[str] = None, **kw) -> "SMPLXModel":
        resolved = find_model_path(path)
        if resolved is None:
            raise FileNotFoundError(
                "SMPL-X model npz not found (set MOTIONCRAFT_SMPLX_MODEL or pass a "
                "path); vertex-level metrics need it")
        with np.load(resolved, allow_pickle=True) as data:
            return cls(dict(data), **kw)

    def _buffers(self) -> Dict[str, torch.Tensor]:
        if self._bufs is None:
            self._bufs = {k: torch.as_tensor(getattr(self, k), dtype=torch.float32,
                                             device=self.device)
                          for k in ("v_template", "shapedirs", "exprdirs", "posedirs",
                                    "J_regressor", "lbs_weights", "pose_mean")}
        return self._bufs

    def forward(self, betas=None, expression=None, global_orient=None, body_pose=None,
                jaw_pose=None, leye_pose=None, reye_pose=None, left_hand_pose=None,
                right_hand_pose=None, transl=None, full_pose=None,
                return_verts: bool = True) -> Dict[str, torch.Tensor]:
        """Batched forward; a part not given is zeros.  ``full_pose`` [B, 165]
        (global, body 63, jaw, leye, reye, lhand 45, rhand 45) overrides the
        parts.  Returns ``joints`` [B, 55, 3] and, with ``return_verts``,
        ``vertices`` [B, V, 3], on the model's device."""
        parts = [global_orient, body_pose, jaw_pose, leye_pose, reye_pose, left_hand_pose,
                 right_hand_pose, betas, expression, transl, full_pose]
        B = next(int(np.shape(p)[0]) for p in parts if p is not None)

        def fill(x, dim):
            if x is None:
                return torch.zeros((B, dim), dtype=torch.float32, device=self.device)
            x = np.asarray(x, np.float32) if not torch.is_tensor(x) else x
            return torch.as_tensor(x, dtype=torch.float32, device=self.device).reshape(B, dim)

        if full_pose is None:
            full_pose = torch.cat([fill(global_orient, 3), fill(body_pose, 63),
                                   fill(jaw_pose, 3), fill(leye_pose, 3), fill(reye_pose, 3),
                                   fill(left_hand_pose, 45), fill(right_hand_pose, 45)], dim=1)
        else:
            full_pose = fill(full_pose, NUM_JOINTS * 3)
        bufs = self._buffers()
        return lbs(full_pose + bufs["pose_mean"], fill(betas, self.num_betas),
                   fill(expression, self.num_expression), fill(transl, 3),
                   parents=self.parents, return_verts=return_verts,
                   **{k: v for k, v in bufs.items() if k != "pose_mean"})

    __call__ = forward

    @torch.no_grad()
    def forward_chunked(self, chunk: int = 256, return_verts: bool = True,
                        **parts) -> Dict[str, np.ndarray]:
        """Forward over a long frame sequence, ``chunk`` frames at a time
        (the skinning of one frame holds V x 3 x 3 floats), back on the host
        as numpy."""
        T = next(int(np.shape(p)[0]) for p in parts.values() if p is not None)
        outs = []
        for s in range(0, T, chunk):
            out = self.forward(return_verts=return_verts,
                               **{k: None if v is None else np.asarray(v)[s:s + chunk]
                                  for k, v in parts.items()})
            outs.append({k: v.cpu().numpy() for k, v in out.items()})
        return {k: np.concatenate([o[k] for o in outs], 0) for k in outs[0]}


def lbs(full_pose: torch.Tensor, betas: torch.Tensor, expression: torch.Tensor,
        transl: torch.Tensor, *, v_template, shapedirs, exprdirs, posedirs,
        J_regressor, lbs_weights, parents, return_verts: bool = True
        ) -> Dict[str, torch.Tensor]:
    """Pose [B, 165] (the mean already added), betas [B, nb], expression
    [B, ne], transl [B, 3] -> joints [B, 55, 3] (+ vertices [B, V, 3])."""
    B = full_pose.shape[0]
    J = len(parents)
    v_shaped = (v_template[None]
                + torch.einsum("bk,vik->bvi", betas, shapedirs)
                + torch.einsum("bk,vik->bvi", expression, exprdirs))
    j_rest = torch.einsum("jv,bvi->bji", J_regressor, v_shaped)             # [B, J, 3]
    rot_mats = axis_angle_to_matrix(full_pose.reshape(B, J, 3))             # [B, J, 3, 3]
    rel = torch.cat([j_rest[:, :1], j_rest[:, 1:] - j_rest[:, parents[1:]]], dim=1)
    Rg, tg = [rot_mats[:, 0]], [rel[:, 0]]
    for i in range(1, J):
        p = int(parents[i])
        Rg.append(Rg[p] @ rot_mats[:, i])
        tg.append(tg[p] + torch.einsum("bij,bj->bi", Rg[p], rel[:, i]))
    Rg = torch.stack(Rg, dim=1)                                             # [B, J, 3, 3]
    joints = torch.stack(tg, dim=1)                                         # [B, J, 3]
    out = {"joints": joints + transl[:, None]}
    if not return_verts:
        return out
    eye = torch.eye(3, dtype=full_pose.dtype, device=full_pose.device)
    pose_feature = (rot_mats[:, 1:] - eye).reshape(B, (J - 1) * 9)
    v_posed = v_shaped + (pose_feature @ posedirs).reshape(B, -1, 3)
    At = joints - torch.einsum("bjik,bjk->bji", Rg, j_rest)                 # [B, J, 3]
    R_skin = torch.einsum("vj,bjik->bvik", lbs_weights, Rg)                 # [B, V, 3, 3]
    t_skin = torch.einsum("vj,bji->bvi", lbs_weights, At)                   # [B, V, 3]
    verts = torch.einsum("bvik,bvk->bvi", R_skin, v_posed) + t_skin
    out["vertices"] = verts + transl[:, None]
    return out


def pose165_parts(pose165) -> Dict[str, np.ndarray]:
    """A BEAT2 smplxflame 165-d axis-angle pose split into the body model's
    parts: global 0:3, body 3:66, jaw 66:69, leye 69:72, reye 72:75, lhand
    75:120, rhand 120:165."""
    return dict(global_orient=pose165[:, 0:3], body_pose=pose165[:, 3:66],
                jaw_pose=pose165[:, 66:69], leye_pose=pose165[:, 69:72],
                reye_pose=pose165[:, 72:75], left_hand_pose=pose165[:, 75:120],
                right_hand_pose=pose165[:, 120:165])
