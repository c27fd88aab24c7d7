"""The evaluation's one resize (evaluation/resize.py, torch) against
``cv2.resize`` at the protocol's shapes: bilinear 64->224 and 256->224
(I3D's preprocessing), bicubic 64->224 and 256->224 (the npz loader and
CLIP), bicubic 64 / 256 -> 128 (C3D).

Limit: at most 1 step of uint8 at any pixel (OpenCV computes uint8 resizes
with fixed-point coefficients); the share of pixels that differ is printed
(``-s``) and held under 15% (the readings: bilinear 11.2-11.6% of pixels,
bicubic up to 0.12%, the 128^2 resizes none)."""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from mm_diffusion_tpu_torch.evaluation.resize import resize_pad_video, resize_uint8  # noqa: E402
from mm_diffusion_tpu.data.video import resize_pad_video as cv2_resize_pad_video  # noqa: E402
from torch_port_common import one_torch_thread  # noqa: F401,E402

CASES = [  # (in, out, mode): the protocol's resizes
    (64, 224, "bilinear"), (256, 224, "bilinear"),
    (64, 224, "bicubic"), (256, 224, "bicubic"),
    (64, 128, "bicubic"), (256, 128, "bicubic"),
]
FLAGS = {"bilinear": cv2.INTER_LINEAR, "bicubic": cv2.INTER_CUBIC}


def _frames(size, seed):
    """Half noise frames, half smooth gradients with edges (a scene's)."""
    rng = np.random.RandomState(seed)
    noise = rng.randint(0, 256, (2, size, size, 3))
    yy, xx = np.mgrid[:size, :size] / size
    smooth = np.stack([(255 * (0.5 + 0.5 * np.sin(6 * xx + 4 * yy + c))) for c in range(3)], -1)
    smooth[size // 3 : size // 2] = 250  # a hard edge
    return np.concatenate([noise, np.stack([smooth, smooth[::-1]])]).astype(np.uint8)


@pytest.mark.parametrize("size_in,size_out,mode", CASES)
def test_resize_matches_cv2_within_one_step(size_in, size_out, mode):
    frames = _frames(size_in, seed=size_in + size_out)
    ref = np.stack([cv2.resize(f, (size_out, size_out), interpolation=FLAGS[mode]) for f in frames])
    got = resize_uint8(frames, size_out, size_out, mode).numpy()
    assert got.dtype == np.uint8 and got.shape == ref.shape
    diff = np.abs(got.astype(np.int32) - ref)
    share = float((diff > 0).mean())
    print(f"{mode} {size_in}->{size_out}: max |diff| {diff.max()}, share of pixels differing {share:.5f}")
    assert diff.max() <= 1
    assert share < 0.15


@pytest.mark.parametrize("shape", [(5, 64, 64, 3), (3, 48, 80, 3), (2, 256, 256, 3)])
def test_resize_pad_video_matches_the_cv2_loader(shape):
    """The npz loader's aspect-preserving resize + centre pad (JAX's calls
    data/video.py::resize_pad_video, OpenCV's bicubic)."""
    frames = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    ref = cv2_resize_pad_video(frames, 224, 224)
    got = resize_pad_video(frames, 224, 224).numpy()
    assert got.shape == ref.shape
    assert np.abs(got.astype(np.int32) - ref).max() <= 1
