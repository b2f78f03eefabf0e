"""Assemble per-increment PNG frames into an animated GIF.

Parity with the reference's offline GIF helper (README.assets/makegift.py,
which sorts saved Newton-step PNGs and builds a GIF with moviepy); here the
frames come from ``FEMSystem.solve(on_increment=...)`` and Pillow does the
encoding (the reference's moviepy is not a dependency).

Host copy of ``femcy_tpu.utils.gif``; Pillow is imported only when a GIF
is written.
"""

from __future__ import annotations

import pathlib
import re
from typing import List, Sequence


def frames_to_gif(
    frames: Sequence[str], path: str, duration_ms: int = 200
) -> str:
    """Encode ordered PNG frame paths into a looping GIF."""
    from PIL import Image

    if not frames:
        raise ValueError("no frames given")
    images = [Image.open(f).convert("P", palette=Image.ADAPTIVE) for f in frames]
    images[0].save(
        path,
        save_all=True,
        append_images=images[1:],
        duration=duration_ms,
        loop=0,
    )
    return path


def collect_frames(directory: str, pattern: str = r".*_(\d+)\.png$") -> List[str]:
    """PNG frames in a directory, ordered by the numeric group in ``pattern``
    (the reference sorts by (time, newton_loop, relax_loop) parsed from file
    names, makegift.py:1-30)."""
    rx = re.compile(pattern)
    hits = []
    for p in sorted(pathlib.Path(directory).glob("*.png")):
        m = rx.match(p.name)
        if m:
            hits.append((int(m.group(1)), str(p)))
    return [p for _, p in sorted(hits)]
