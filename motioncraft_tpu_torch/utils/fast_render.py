"""Frame-parallel SMPL-X mesh video rendering (port of
motioncraft_tpu/utils/fast_render.py).

Vertices come from the port's LBS body model (ops/smplx_lbs.py: only the
model npz is needed, not the smplx package); frames are rendered by a pool
of spawned workers, each with its own pyrender OffscreenRenderer (GL
contexts cannot be forked); the frames are muxed with imageio (and an
optional moviepy audio track).  pyrender, trimesh, imageio and moviepy are
imported where they are used.

The per-frame renderer is injectable, so the orchestration runs without
pyrender.
"""

from __future__ import annotations

import math
import multiprocessing as mp
import os
import tempfile
from typing import Callable, List, Optional, Sequence

import numpy as np


def split_frames(total: int, n_chunks: int) -> List[List[int]]:
    """Contiguous frame-index chunks, one per worker (fast_render.py:137-150
    semantics: every frame exactly once, chunks as even as possible)."""
    n_chunks = max(1, min(n_chunks, total))
    per = math.ceil(total / n_chunks)
    return [list(range(s, min(s + per, total)))
            for s in range(0, total, per)]


def _pyrender_frame_renderer(width: int, height: int):
    """Default worker-side factory: pyrender offscreen scene per frame
    (fast_render.py:35-62 camera/light setup)."""
    import pyrender
    import trimesh

    renderer = pyrender.OffscreenRenderer(width, height)
    angle = math.radians(-2)
    pose_camera = np.array([[1, 0, 0, 0],
                            [0, math.cos(angle), -math.sin(angle), 1.0],
                            [0, math.sin(angle), math.cos(angle), 5.0],
                            [0, 0, 0, 1.0]])
    lr = math.radians(-30)
    pose_light = np.array([[1, 0, 0, 0],
                           [0, math.cos(lr), -math.sin(lr), 0.0],
                           [0, math.sin(lr), math.cos(lr), 3.0],
                           [0, 0, 0, 1.0]])

    def render(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
        mesh = trimesh.Trimesh(vertices=vertices, faces=faces,
                               vertex_colors=[220, 220, 220, 255])
        scene = pyrender.Scene()
        scene.add(pyrender.Mesh.from_trimesh(mesh, smooth=True))
        scene.add(pyrender.OrthographicCamera(xmag=1.0, ymag=1.0),
                  pose=pose_camera)
        scene.add(pyrender.DirectionalLight(color=[1.0, 1.0, 1.0],
                                            intensity=4.0), pose=pose_light)
        color, _ = renderer.render(scene)
        return color

    return render


def _worker(args):
    """Render one chunk of frames to PNGs (spawn-safe, module level)."""
    (fids, vertices, faces, out_dir, width, height, factory) = args
    # v2 API pinned: bare `import imageio` is on a deprecation path to
    # v3 semantics (different imread return types / kwargs)
    import imageio.v2 as imageio
    render = (factory or _pyrender_frame_renderer)(width, height)
    for i, fid in enumerate(fids):
        imageio.imwrite(os.path.join(out_dir, f"frame_{fid:06d}.png"),
                        np.asarray(render(vertices[i], faces)))
    return len(fids)


def render_frames_multiprocess(
        vertices: np.ndarray, faces: np.ndarray, out_video: str,
        fps: int = 30, n_workers: Optional[int] = None,
        audio_path: Optional[str] = None, width: int = 640, height: int = 480,
        frame_renderer_factory: Optional[Callable] = None) -> str:
    """vertices [T, V, 3] -> video at ``out_video``.

    Frames render in parallel worker processes (each with its own GL
    context); the parent muxes PNGs into the video and optionally adds the
    audio track.  Returns the written path."""
    T = len(vertices)
    n_workers = n_workers or min(mp.cpu_count(), 8, T)
    chunks = split_frames(T, n_workers)
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(fids, np.ascontiguousarray(vertices[fids[0]:fids[-1] + 1]),
                 faces, tmp, width, height, frame_renderer_factory)
                for fids in chunks]
        if len(jobs) == 1:
            _worker(jobs[0])
        else:
            ctx = mp.get_context("spawn")
            with ctx.Pool(len(jobs)) as pool:
                pool.map(_worker, jobs)
        import imageio.v2 as imageio
        frames = [imageio.imread(os.path.join(tmp, f"frame_{t:06d}.png"))
                  for t in range(T)]
    if out_video.lower().endswith(".gif"):
        # the PIL GIF plugin dropped `fps` in favor of per-frame duration (ms)
        imageio.mimwrite(out_video, frames, duration=1000.0 / fps)
    else:
        imageio.mimwrite(out_video, frames, fps=fps)
    if audio_path and os.path.isfile(audio_path):
        try:
            import moviepy.editor as mpy
            clip = mpy.VideoFileClip(out_video)
            clip = clip.set_audio(mpy.AudioFileClip(audio_path))
            muxed = os.path.splitext(out_video)[0] + "_audio.mp4"
            clip.write_videofile(muxed, logger=None)
            return muxed
        except Exception:
            pass
    return out_video


def smplx_vertices_for_render(poses: np.ndarray, trans: np.ndarray,
                              expressions: Optional[np.ndarray] = None,
                              betas: Optional[np.ndarray] = None,
                              model_path: Optional[str] = None, device="cuda"):
    """165-d poses + trans (+ 100-d expressions, 300-d betas) -> (vertices
    [T, V, 3], faces) by the port's LBS body model (ops/smplx_lbs.py) on
    ``device`` (the card unless told); needs only the SMPL-X npz asset."""
    from ..ops.smplx_lbs import SMPLXModel, pose165_parts
    model = SMPLXModel.from_npz(model_path, device=device)
    T = len(poses)
    parts = pose165_parts(np.asarray(poses, np.float32))
    if betas is not None:
        betas = np.broadcast_to(np.asarray(betas, np.float32).reshape(1, -1)
                                [:, :model.num_betas], (T, model.num_betas))
    out = model.forward_chunked(transl=np.asarray(trans, np.float32),
                                expression=expressions, betas=betas, **parts)
    return np.asarray(out["vertices"]), model.faces
