"""Write the disc dataset under ``tests/data/discs``: 24 image/mask JPEG
pairs at 512^2, bright discs on a smooth background, the masks 255 inside
the discs.  The files are committed; this script is how they were made:

    python tests/data/make_discs.py

It needs numpy and cv2.
"""

import os

import cv2
import numpy as np

N, SIZE, SEED = 24, 512, 0
HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "discs")


def main() -> None:
    rs = np.random.RandomState(SEED)
    yy, xx = np.mgrid[:SIZE, :SIZE].astype(np.float32) / SIZE
    for sub in ("images", "masks"):
        os.makedirs(os.path.join(HERE, sub), exist_ok=True)
    for i in range(N):
        fy, fx, phase = rs.uniform(1.0, 3.0, 2).tolist() + [rs.uniform(0, 2 * np.pi)]
        base = 60 + 40 * np.sin(2 * np.pi * (fy * yy + fx * xx) + phase)
        image = np.stack([base, base * 0.8 + 20, 120 - base * 0.5], -1)
        mask = np.zeros((SIZE, SIZE), np.uint8)
        for _ in range(rs.randint(1, 4)):
            cy, cx = rs.randint(64, SIZE - 64, 2)
            rad = rs.randint(24, 80)
            disc = (yy * SIZE - cy) ** 2 + (xx * SIZE - cx) ** 2 < rad * rad
            image[disc] = (230, 220, 200)
            mask[disc] = 255
        name = f"disc_{i:02d}.jpg"
        cv2.imwrite(os.path.join(HERE, "images", name),
                    cv2.cvtColor(np.clip(image, 0, 255).astype(np.uint8), cv2.COLOR_RGB2BGR),
                    [cv2.IMWRITE_JPEG_QUALITY, 85])
        cv2.imwrite(os.path.join(HERE, "masks", name), mask, [cv2.IMWRITE_JPEG_QUALITY, 90])


if __name__ == "__main__":
    main()
