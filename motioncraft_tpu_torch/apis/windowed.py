"""Windowed long-form generation with overlap seeding / RePaint outpainting
(PyTorch port of motioncraft_tpu/apis/windowed.py).

A recording is generated window by window (for music-to-dance, 120-frame
windows overlapping by 30, the condition 163-d music features a frame; for
speech-to-gesture, 64-frame windows overlapping by 4, the condition the
window's audio samples, onset and amplitude at 16 kHz, [1, 64 x 533, 2]):
the condition slice goes through as it is, whatever its length, and the
model encodes it once a sampling call.  The first window is plain DDIM;
each later one is outpainted from the previous window's tail by RePaint's
harmonized DDIM (``use_repaint``) or seeded with it by q_sample
(``pre_seq``).  The loop
over windows runs on the host, but nothing in it waits for the device: the
window batches go up in pinned memory without a sync, the carry (the last
window, the noisy-tail bank) stays on the device, every per-step decision
comes from the host-side schedule (diffusion/sampling.py), and the outputs
come back in one copy at the end.

All carries stay in normalised space; ``denormalize`` runs once at the end.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..diffusion.sampling import Outpainting, Randn, RepaintConfig


def num_windows(total_frames: int, window: int, pre_frames: int) -> int:
    """(n - pre) // (window - pre), at least 1."""
    return max(1, (total_frames - pre_frames) // (window - pre_frames))


def denormalize(motion: np.ndarray, mean: np.ndarray, std: np.ndarray,
                eps: float = 1e-9) -> np.ndarray:
    return motion * (std + eps) + mean


def _upload(a, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; to the card through pinned memory, so the
    copy does not wait for the work queued before it."""
    t = a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _sample_window(arch, batch, w, last, tails, *, use_repaint, repaint, pre_frames, randn):
    """Window ``w`` of a recording: (sample [B, window, D], tail bank)."""
    if w == 0:
        out = arch.sample(batch, randn=randn)
        return (out[0] if isinstance(out, tuple) else out), tails
    if not use_repaint:
        out = arch.sample(batch, randn=randn, pre_seq=last[:, -pre_frames:])
        return (out[0] if isinstance(out, tuple) else out), tails
    if tails is None and repaint.same_overlap_noisy:
        tails = last.new_zeros((arch.diffusion_test.num_timesteps, last.shape[0],
                                repaint.overlap_len, last.shape[-1]))
    T = last.shape[1]
    mask = (torch.arange(T, device=last.device) < pre_frames).reshape(1, T, 1)
    gt = torch.cat([last[:, -pre_frames:], last.new_zeros(
        (last.shape[0], T - pre_frames, last.shape[-1]))], dim=1)
    op = Outpainting(mask=mask, gt=gt,
                     clip_idx=1 if (repaint.same_overlap_noisy and w >= 2) else 0,
                     previous_noisy_tail=tails)
    out = arch.sample(batch, randn=randn, outpainting=op)
    return out if isinstance(out, tuple) else (out, tails)


def windowed_sample(arch, make_window_batch: Callable[[int, int], Dict], *,
                    total_frames: int, window: int, pre_frames: int,
                    randn: Optional[Randn] = None, use_repaint: bool = True,
                    repaint: Optional[RepaintConfig] = None) -> np.ndarray:
    """Generate ``total_frames`` of one recording, window by window:
    ``make_window_batch(start, end)`` returns the batch of frames
    [start, end) as arrays (zeros motion [1, window, D], its mask and
    length, the text ids and the aligned condition slice ``c``).  Every
    draw comes from ``randn`` (diffusion/sampling.py; the card's global
    generator when None).  Returns [total_frames, D] (normalised)."""
    repaint = repaint or RepaintConfig(overlap_len=pre_frames)
    stride = window - pre_frames
    kw = dict(use_repaint=use_repaint, repaint=repaint, pre_frames=pre_frames, randn=randn)
    samples, last, tails = [], None, None
    for w in range(num_windows(total_frames, window, pre_frames)):
        batch = {k: _upload(v, arch.device)
                 for k, v in make_window_batch(w * stride, w * stride + window).items()}
        last, tails = _sample_window(arch, batch, w, last, tails, **kw)
        samples.append(last)
    host = torch.stack(samples).cpu().numpy()  # the one wait for the device
    full = np.concatenate([host[0][0]] + [h[0][pre_frames:] for h in host[1:]], axis=0)
    return full[:total_frames]


def _concat_parts(parts: List[Dict]) -> Dict:
    """Per-recording window batches concatenated over the batch axis
    (numeric keys only); trailing condition slices zero-padded to a common
    length."""
    batch: Dict = {}
    for key in parts[0]:
        vals = [np.asarray(p[key]) for p in parts]
        if not np.issubdtype(vals[0].dtype, np.number):
            continue
        if vals[0].ndim > 1:
            maxlen = max(v.shape[1] for v in vals)
            vals = [np.pad(v, [(0, 0), (0, maxlen - v.shape[1])] + [(0, 0)] * (v.ndim - 2))
                    for v in vals]
        batch[key] = np.concatenate(vals, axis=0)
    return batch


def windowed_sample_batch(arch, make_window_batches: List[Callable[[int, int], Dict]],
                          total_frames_list: List[int], *, window: int, pre_frames: int,
                          randn: Optional[Randn] = None, use_repaint: bool = True,
                          repaint: Optional[RepaintConfig] = None,
                          precompute_condition: bool = True,
                          window_chunk: Optional[int] = None) -> List[np.ndarray]:
    """R recordings in lockstep: window w of all R runs as one [R, window, D]
    batch.  Recordings shorter than the longest keep sampling padded windows
    whose outputs are dropped.

    The host works per chunk of ``window_chunk`` windows (default about 256
    windows of all recordings): it builds the chunk's batches, sends the
    arrays every window shares once and the others as [n_chunk, ...] banks,
    and (``precompute_condition``, for a model with ``encode_condition``)
    encodes the chunk's condition slices in one call.  The window loop
    slices the banks on the device.  Returns one [total_frames_r, D] array
    per recording (normalised)."""
    R = len(make_window_batches)
    if R != len(total_frames_list):
        raise ValueError(f"{R} recordings but {len(total_frames_list)} lengths")
    repaint = repaint or RepaintConfig(overlap_len=pre_frames)
    rounds = [num_windows(tf, window, pre_frames) for tf in total_frames_list]
    stride = window - pre_frames
    chunk = window_chunk or max(1, 256 // R)
    kw = dict(use_repaint=use_repaint, repaint=repaint, pre_frames=pre_frames, randn=randn)
    encode = precompute_condition and hasattr(arch.model, "encode_condition")

    samples, last, tails = [], None, None
    for c0 in range(0, max(rounds), chunk):
        ws = range(c0, min(c0 + chunk, max(rounds)))
        wins = [_concat_parts([mwb(w * stride, w * stride + window)
                               for mwb in make_window_batches]) for w in ws]
        banked = {}
        if "c" in wins[0]:
            cs = [b.pop("c") for b in wins]
            L = max(c.shape[1] for c in cs)
            cs = np.stack([np.pad(c, [(0, 0), (0, L - c.shape[1])] + [(0, 0)] * (c.ndim - 2))
                           for c in cs])
            if encode:
                with torch.no_grad():
                    enc = arch.model.encode_condition(
                        _upload(cs.reshape((len(ws) * R,) + cs.shape[2:]), arch.device),
                        window)
                banked["c_enc"] = enc.reshape((len(ws), R) + enc.shape[1:])
            else:
                banked["c"] = _upload(cs, arch.device)
        static = {}
        for k in wins[0]:
            vals = [b[k] for b in wins]
            if all(v.shape == vals[0].shape and np.array_equal(v, vals[0]) for v in vals[1:]):
                static[k] = _upload(vals[0], arch.device)
            else:
                banked[k] = _upload(np.stack(vals), arch.device)
        for i, w in enumerate(ws):
            # a fresh copy of each banked slice: the products that read it
            # see the same alignment as an unbanked window's, so give the
            # same bits
            batch = {**static, **{k: v[i].clone() for k, v in banked.items()}}
            last, tails = _sample_window(arch, batch, w, last, tails, **kw)
            samples.append(last)

    host = torch.stack(samples).cpu().numpy()  # the one wait for the device
    outs = []
    for r, (n, tf) in enumerate(zip(rounds, total_frames_list)):
        parts = [host[0][r]] + [host[w][r][pre_frames:] for w in range(1, n)]
        outs.append(np.concatenate(parts, axis=0)[:tf])
    return outs
