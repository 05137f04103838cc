"""Video/visualization IO: gif, mp4, npz, joblib writers and box overlays (a
copy of lvd_tpu/utils/vis.py). GIFs are written by PIL, lvd_tpu's own path
where its native encoder is absent; mp4 uses cv2 when present, else is
skipped with a warning.
"""

from __future__ import annotations

import os
from typing import Iterable, Sequence

import numpy as np
from PIL import Image, ImageDraw


def _ensure_parent(path: str):
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)


def save_gif(path: str, frames: Sequence[np.ndarray], fps: int = 8):
    _ensure_parent(path)
    frames = np.asarray(frames, np.uint8)
    images = [Image.fromarray(np.asarray(f, np.uint8)) for f in frames]
    images[0].save(
        path,
        save_all=True,
        append_images=images[1:],
        duration=int(1000 / fps),
        loop=0,
    )
    return path


def save_mp4(path: str, frames: Sequence[np.ndarray], fps: int = 8):
    try:
        import cv2
    except ImportError:
        print(f"cv2 unavailable; skipping mp4 output {path}")
        return None
    _ensure_parent(path)
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(
        path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
    )
    for f in frames:
        writer.write(cv2.cvtColor(np.asarray(f, np.uint8), cv2.COLOR_RGB2BGR))
    writer.release()
    return path


def save_joblib(path: str, frames: np.ndarray):
    try:
        import joblib
    except ImportError:
        # npz fallback keeps the artifact loadable by our own eval CLI.
        alt = path.replace(".joblib", ".npz")
        np.savez_compressed(alt, frames=np.asarray(frames))
        print(f"joblib unavailable; saved npz instead: {alt}")
        return alt
    _ensure_parent(path)
    joblib.dump(np.asarray(frames), path, compress=("bz2", 3))
    return path


def load_video(path: str) -> np.ndarray:
    """Load a video saved by save_frames (joblib or npz)."""
    if path.endswith(".npz"):
        return np.load(path)["frames"]
    import joblib

    return joblib.load(path)


def save_frames(
    path: str, frames, formats: Iterable[str] = ("gif", "joblib"), fps: int = 8
):
    """Save uint8 frames (F, H, W, 3) under ``path`` with each requested
    extension (reference utils/vis.py:142-161 semantics)."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = (np.clip(frames, 0, 1) * 255).round().astype(np.uint8)
    if isinstance(formats, str):
        formats = [formats]
    written = []
    for fmt in formats:
        if fmt == "gif":
            written.append(save_gif(f"{path}.gif", frames, fps))
        elif fmt == "mp4":
            out = save_mp4(f"{path}.mp4", frames, fps)
            if out:
                written.append(out)
        elif fmt == "joblib":
            written.append(save_joblib(f"{path}.joblib", frames))
        elif fmt == "npz":
            _ensure_parent(f"{path}.npz")
            np.savez_compressed(f"{path}.npz", frames=frames)
            written.append(f"{path}.npz")
        else:
            raise ValueError(f"Unknown format: {fmt}")
    return written


def draw_box(pil_img: Image.Image, boxes, phrases, ignore_all_zeros: bool = True):
    """Annotate normalized xyxy boxes + phrases on an image (red outlines)."""
    w, h = pil_img.size
    draw = ImageDraw.Draw(pil_img)
    for box, phrase in zip(boxes, phrases):
        if ignore_all_zeros and all(v == 0 for v in box):
            continue
        x0, y0, x1, y1 = box
        draw.rectangle(
            [int(x0 * w), int(y0 * h), int(x1 * w), int(y1 * h)],
            outline="red",
            width=3,
        )
        draw.text((int(x0 * w) + 4, int(y0 * h) + 4), str(phrase), fill=(255, 0, 0))
    return pil_img
