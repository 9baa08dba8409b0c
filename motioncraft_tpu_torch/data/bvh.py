"""A minimal BVH mocap parser (copy of motioncraft_tpu/data/bvh.py, which
the port does not import): the hierarchy (joints, offsets, channel order)
and the motion frames into numpy arrays."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class BVHJoint:
    name: str
    parent: Optional[int]
    offset: np.ndarray
    channels: List[str] = field(default_factory=list)
    channel_offset: int = 0


@dataclass
class BVHData:
    joints: List[BVHJoint]
    frames: np.ndarray  # [T, n_channels]
    frame_time: float

    @property
    def parents(self) -> np.ndarray:
        return np.asarray([-1 if j.parent is None else j.parent
                           for j in self.joints], np.int32)

    @property
    def offsets(self) -> np.ndarray:
        return np.stack([j.offset for j in self.joints])

    def joint_channels(self, name: str) -> np.ndarray:
        for j in self.joints:
            if j.name == name:
                return self.frames[:, j.channel_offset:
                                   j.channel_offset + len(j.channels)]
        raise KeyError(name)


def parse_bvh(path: str) -> BVHData:
    with open(path) as f:
        tokens = f.read().split()
    i = 0

    def expect(tok):
        nonlocal i
        if tokens[i].upper() != tok:
            raise ValueError(f"expected {tok} at token {i}, got {tokens[i]}")
        i += 1

    joints: List[BVHJoint] = []
    channel_count = 0

    def parse_joint(parent: Optional[int]):
        nonlocal i, channel_count
        kind = tokens[i].upper()
        i += 1
        if kind == "END":  # "End Site"
            i += 1  # Site
            expect("{")
            expect("OFFSET")
            offset = np.asarray([float(tokens[i + k]) for k in range(3)])
            i += 3
            joints.append(BVHJoint(f"{joints[parent].name}_end", parent, offset))
            expect("}")
            return
        name = tokens[i]
        i += 1
        expect("{")
        expect("OFFSET")
        offset = np.asarray([float(tokens[i + k]) for k in range(3)])
        i += 3
        expect("CHANNELS")
        n = int(tokens[i]); i += 1
        channels = [tokens[i + k] for k in range(n)]
        i += n
        idx = len(joints)
        joints.append(BVHJoint(name, parent, offset, channels, channel_count))
        channel_count += n
        while tokens[i].upper() in ("JOINT", "END"):
            parse_joint(idx)
        expect("}")

    expect("HIERARCHY")
    expect("ROOT")
    i -= 1  # parse_joint consumes the JOINT/ROOT keyword
    tokens[i] = "JOINT"
    parse_joint(None)

    expect("MOTION")
    expect("FRAMES:")
    n_frames = int(tokens[i]); i += 1
    # "Frame Time:" tokenizes as two tokens
    expect("FRAME")
    expect("TIME:")
    frame_time = float(tokens[i]); i += 1
    data = np.asarray([float(v) for v in tokens[i:i + n_frames * channel_count]],
                      np.float32).reshape(n_frames, channel_count)
    return BVHData(joints=joints, frames=data, frame_time=frame_time)
