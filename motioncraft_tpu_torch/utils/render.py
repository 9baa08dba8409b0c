"""SMPL-X rendering (port of motioncraft_tpu/utils/render.py).

A generated clip becomes an SMPL-X mesh video by pyrender (offscreen) when
pyrender, trimesh and the SMPL-X body-model assets are all there, else a
matplotlib FK stick figure.  Each is looked for at the call; the renderers'
packages are imported where they are used.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def have_mesh_renderer() -> bool:
    try:
        import pyrender  # noqa: F401
        import trimesh  # noqa: F401
        return True
    except ImportError:
        return False


def have_smplx_model(model_path: Optional[str] = None) -> Optional[str]:
    for cand in [model_path, os.environ.get("MOTIONCRAFT_SMPLX_MODELS"),
                 "./data/smplx_models"]:
        if cand and os.path.isdir(cand):
            return cand
    return None


def render_one_sequence(npz_path: str, out_video: str,
                        audio_path: Optional[str] = None,
                        model_path: Optional[str] = None, fps: int = 30,
                        device="cuda") -> str:
    """SMPL-X npz -> video: the mesh (pyrender and the SMPL-X assets) where
    both are there, the FK stick figure otherwise; the body model or the FK
    runs on ``device`` (the card unless told).  Returns the path written."""
    data = np.load(npz_path, allow_pickle=True)
    poses, trans = data["poses"], data["trans"]

    models = have_smplx_model(model_path)
    if have_mesh_renderer() and models is not None:
        return _render_mesh(poses, trans, data, out_video, models, audio_path, fps, device)
    return _render_skeleton(poses, trans, out_video, fps, device)


def _render_skeleton(poses: np.ndarray, trans: np.ndarray, out_video: str,
                     fps: int, device="cuda") -> str:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    from ..ops.fk import SMPLX_PARENTS, SMPLXSkeleton

    fk = SMPLXSkeleton(device=device)
    joints = fk(np.asarray(poses, np.float32), np.asarray(trans, np.float32)).cpu().numpy()
    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(projection="3d")

    def draw(t):
        ax.cla()
        ax.set_xlim(-1, 1); ax.set_ylim(-1, 1); ax.set_zlim(-1, 1)
        j = joints[t]
        for i, p in enumerate(SMPLX_PARENTS):
            if p >= 0:
                ax.plot([j[i, 0], j[p, 0]], [j[i, 2], j[p, 2]],
                        [j[i, 1], j[p, 1]], "b-", lw=1)

    anim = animation.FuncAnimation(fig, draw, frames=len(joints),
                                   interval=1000 / fps)
    try:
        anim.save(out_video, fps=fps)
    except Exception:
        out_video = os.path.splitext(out_video)[0] + ".gif"
        anim.save(out_video, writer="pillow", fps=fps)
    plt.close(fig)
    return out_video


def _render_mesh(poses, trans, data, out_video, model_path, audio_path, fps, device="cuda"):
    """A frame-parallel pyrender mesh video: vertices from the port's LBS
    body model (only the SMPL-X npz asset needed), frames rendered by a
    spawn pool of pyrender workers, muxed with imageio."""
    from ..ops.smplx_lbs import find_model_path
    from .fast_render import render_frames_multiprocess, smplx_vertices_for_render

    npz = find_model_path(os.path.join(model_path, "smplx", "SMPLX_NEUTRAL_2020.npz"))
    vertices, faces = smplx_vertices_for_render(
        poses, trans,
        expressions=np.asarray(data["expressions"], np.float32)
        if "expressions" in data else None,
        betas=np.asarray(data["betas"], np.float32) if "betas" in data else None,
        model_path=npz, device=device)
    return render_frames_multiprocess(vertices, faces, out_video, fps=fps,
                                      audio_path=audio_path)
