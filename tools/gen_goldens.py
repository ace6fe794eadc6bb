#!/usr/bin/env python
"""(Re)generate the fixed-seed golden renders in tests/golden/.

Run on the CPU backend (same platform as the test suite):
    JAX_PLATFORMS=cpu TPT_STEPS_PER_ITER=1 python tools/gen_goldens.py

Only run this deliberately — a golden refresh must accompany an intended
estimator change, never paper over a regression."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("TPT_STEPS_PER_ITER", "1")

import numpy as np

from cudapathtracer_tpu import goldens


def main():
    frame = goldens.setup()
    for name in goldens.FAMILIES:
        fname = goldens.family(name)[0]
        img = goldens.render(frame, name)
        assert np.isfinite(img).all(), name
        np.save(os.path.join(goldens.GOLDEN_DIR, fname), img)
        print(f"{fname}: mean={img.mean():.4f} max={img.max():.3f}")


if __name__ == "__main__":
    main()
