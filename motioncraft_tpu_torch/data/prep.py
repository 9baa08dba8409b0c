"""Data preparation (port of motioncraft_tpu/data/prep.py).

- ``humanml3d_clip_align``: align Motion-X SMPL-X motions to HumanML3D
  caption time spans: captions with (f_tag, to_tag) spans become clips of
  their own (40 frames or more), full-span captions keep the whole motion;
  writes each clip's .npy / .txt and the annotation list.
- ``finedance_motion_feats``: raw FineDance (trans + 52 x 6d rotations) ->
  319-d features (4 foot contacts + 3 trans + 312 rot6d), the contacts from
  FK foot velocities on the port's SMPL-X skeleton.
- ``compute_norm_stats``: a dataset's mean / std .npy files.

  python -m motioncraft_tpu_torch.data.prep finedance_feats --inputs-dir RAW \
      --outputs-dir OUT [--device cpu]
"""

from __future__ import annotations

import glob
import os
import random
from os.path import join as pjoin
from typing import Optional

import numpy as np


def humanml3d_clip_align(base_path: str, output_dir_name: str, ann_file: str,
                         fps: int = 30, min_frames: int = 40) -> int:
    with open(ann_file) as f:
        id_list = [line.strip() for line in f if len(line.strip()) == 6]

    out_names = []
    os.makedirs(pjoin(base_path, "texts/semantic_labels", output_dir_name), exist_ok=True)
    os.makedirs(pjoin(base_path, "motion_data/smplx_322", output_dir_name), exist_ok=True)

    for mid in id_list:
        motion_path = pjoin(base_path, "motion_data/smplx_322/humanml", mid + ".npy")
        text_path = pjoin(base_path, "texts/semantic_labels/humanml", mid + ".txt")
        if not (os.path.exists(motion_path) and os.path.exists(text_path)):
            continue
        motion = np.load(motion_path)
        if len(motion) < min_frames:
            continue
        full_captions = []
        with open(text_path) as f:
            for line in f:
                parts = line.strip().split("#")
                if len(parts) < 4:
                    continue
                caption = parts[0]
                f_tag = 0.0 if parts[2] in ("nan", "") else float(parts[2])
                to_tag = 0.0 if parts[3] in ("nan", "") else float(parts[3])
                f_tag = 0.0 if np.isnan(f_tag) else f_tag
                to_tag = 0.0 if np.isnan(to_tag) else to_tag
                if f_tag == 0.0 and to_tag == 0.0:
                    full_captions.append(caption)
                else:
                    clip = motion[int(f_tag * fps):int(to_tag * fps)]
                    if len(clip) < min_frames:
                        continue
                    new_name = random.choice("ABCDEFGHIJKLMNOPQRSTUVW") + "_" + mid
                    while new_name in out_names:
                        new_name = random.choice("ABCDEFGHIJKLMNOPQRSTUVW") + "_" + mid
                    with open(pjoin(base_path, "texts/semantic_labels",
                                    output_dir_name, new_name + ".txt"), "w") as tf:
                        tf.write(caption + "\n")
                    np.save(pjoin(base_path, "motion_data/smplx_322",
                                  output_dir_name, new_name + ".npy"), clip)
                    out_names.append(new_name)
        if full_captions:
            with open(pjoin(base_path, "texts/semantic_labels", output_dir_name,
                            mid + ".txt"), "w") as tf:
                tf.write("\n".join(full_captions) + "\n")
            np.save(pjoin(base_path, "motion_data/smplx_322", output_dir_name,
                          mid + ".npy"), motion)
            out_names.append(mid)

    with open(pjoin(base_path, output_dir_name + ".txt"), "w") as f:
        f.write("\n".join("humanml/" + n for n in out_names) + "\n")
    return len(out_names)


def finedance_motion_feats(inputs_dir: str, outputs_dir: str,
                           contact_thresh: float = 0.01, device="cuda") -> int:
    """Raw FineDance [T, 3 + 312] (trans + 52 joints x rot6d) -> 319-d
    features with FK-derived foot contacts; the rotations and the FK run
    on ``device`` (the card unless told)."""
    import torch

    from ..ops.fk import SMPLXSkeleton
    from ..ops.rotation import ax_from_6v

    os.makedirs(outputs_dir, exist_ok=True)
    fk = SMPLXSkeleton(device=device)
    count = 0
    for path in sorted(glob.glob(os.path.join(inputs_dir, "*.npy"))):
        data = np.load(path, allow_pickle=True)
        pos = data[:, :3]
        rot6d = data[:, 3:]
        T = len(data)
        local_q = ax_from_6v(torch.as_tensor(np.asarray(rot6d, np.float32).reshape(T, 52, 6),
                                             device=fk.device)).reshape(T, 156)
        joints = fk(local_q, np.asarray(pos, np.float32)).cpu().numpy()
        feet = joints[:, (7, 8, 10, 11)]
        feetv = np.zeros(feet.shape[:2], np.float32)
        feetv[:-1] = np.linalg.norm(feet[1:] - feet[:-1], axis=-1)
        contacts = (feetv < contact_thresh).astype(np.float32)
        feats = np.concatenate([contacts, pos, rot6d], axis=1).astype(np.float32)
        assert feats.shape[1] == 319
        name = os.path.splitext(os.path.basename(path))[0]
        np.save(os.path.join(outputs_dir, name + ".npy"), feats)
        count += 1
    return count


def compute_norm_stats(motion_dir: str, out_dir: str,
                       pattern: str = "*.npy") -> None:
    """Per-dim mean/std over a motion directory -> mean.npy/std.npy."""
    files = sorted(glob.glob(os.path.join(motion_dir, pattern)))
    if not files:
        raise FileNotFoundError(f"no motions under {motion_dir}")
    acc, acc2, n = 0.0, 0.0, 0
    for path in files:
        m = np.load(path).astype(np.float64)
        acc = acc + m.sum(0)
        acc2 = acc2 + (m ** 2).sum(0)
        n += len(m)
    mean = acc / n
    std = np.sqrt(np.maximum(acc2 / n - mean ** 2, 0))
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "mean.npy"), mean.astype(np.float32))
    np.save(os.path.join(out_dir, "std.npy"), std.astype(np.float32))


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("humanml3d_align")
    a.add_argument("--base-path", required=True)
    a.add_argument("--output-dir-name", required=True)
    a.add_argument("--ann-file", required=True)
    b = sub.add_parser("finedance_feats")
    b.add_argument("--inputs-dir", required=True)
    b.add_argument("--outputs-dir", required=True)
    b.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the FK runs; cuda raises without a card")
    c = sub.add_parser("norm_stats")
    c.add_argument("--motion-dir", required=True)
    c.add_argument("--out-dir", required=True)
    args = p.parse_args()
    if args.cmd == "humanml3d_align":
        n = humanml3d_clip_align(args.base_path, args.output_dir_name, args.ann_file)
        print(f"wrote {n} aligned clips")
    elif args.cmd == "finedance_feats":
        n = finedance_motion_feats(args.inputs_dir, args.outputs_dir, device=args.device)
        print(f"wrote {n} files")
    else:
        compute_norm_stats(args.motion_dir, args.out_dir)
        print("stats written")
