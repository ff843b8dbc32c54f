"""Write the committed MPEG-4 test clip `torch_clip_128x96.mp4`.

    python tests/data/make_torch_clip.py [--seed 0]

128x96, 30 frames at 10 fps, MPEG-4 part 2 (`mp4v`) through cv2's
writer, as tests/test_media.py's `_write_clip` makes its clips. Each
frame is a smooth seeded colour field that drifts from frame to frame,
under a bright red band across the top quarter, so a rotated decode is
told apart from a plain one. The tests and chip_smoke.py derive the
tkhd-rotated copy and the cover-art MP3s in pure Python; the card's
machine needs no video encoder.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

W, H, FRAMES, FPS = 128, 96, 30, 10
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_clip_128x96.mp4")


def frames(seed: int) -> list[np.ndarray]:
    """The clip's BGR frames."""
    import cv2

    rng = np.random.default_rng(seed)
    coarse = rng.integers(40, 200, (4, 5, 3)).astype(np.float32)
    drift = rng.integers(-3, 4, 3).astype(np.float32)
    out = []
    for i in range(FRAMES):
        field = cv2.resize(np.clip(coarse + drift * i, 0, 255), (W, H),
                           interpolation=cv2.INTER_LINEAR)
        frame = field.astype(np.uint8)
        frame[: H // 4] = (0, 0, 240)  # red in BGR
        out.append(frame)
    return out


def main() -> None:
    import cv2

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=OUT)
    args = parser.parse_args()
    vw = cv2.VideoWriter(args.out, cv2.VideoWriter_fourcc(*"mp4v"), FPS, (W, H))
    if not vw.isOpened():
        raise SystemExit("cv2 cannot write mp4v here")
    for frame in frames(args.seed):
        vw.write(frame)
    vw.release()
    print(args.out, os.path.getsize(args.out))


if __name__ == "__main__":
    main()
