"""The port's host-side evaluation code against the JAX package's on the
CPU: the float64 metrics, the Inception Scores, the log-mel embedder, the
TensorBundle format code, the npz batch files and loader, and the I3D
preprocessing.

Limits: the metrics, IS, log-mel and bundle reader run the same float64 /
byte code as JAX, held to 1e-10 relative (arrays bitwise); the batch files
are the same bytes' contents (keys, dtypes, shapes, values exactly); the
loader's video and the I3D preprocessing follow the resize's documented
1-step uint8 difference (evaluation/resize.py): at most 1/127.5 and 2/255
in [-1, 1] values, the audio exactly."""

import numpy as np
import pytest

from mm_diffusion_tpu.evaluation import audio_embed as jax_audio_embed
from mm_diffusion_tpu.evaluation import inception_score as jax_is
from mm_diffusion_tpu.evaluation import metrics as jax_metrics
from mm_diffusion_tpu.evaluation import npz_batch as jax_npz
from mm_diffusion_tpu.evaluation import tf_bundle as jax_bundle
from mm_diffusion_tpu_torch.evaluation import audio_embed, inception_score, metrics, npz_batch, tf_bundle
from torch_port_common import one_torch_thread  # noqa: F401

REL = 1e-10


def _sets(seed, n=40, d=12):
    rng = np.random.RandomState(seed)
    return rng.randn(n, d) * 2 + 1, rng.randn(n + 7, d) * 1.5


@pytest.mark.parametrize("fn", ["frechet_distance", "polynomial_mmd", "trace_sqrt_product"])
def test_distribution_metrics_match_jax(fn):
    x, y = _sets(0)
    if fn == "trace_sqrt_product":
        x, y = np.cov(x, rowvar=False), np.cov(y, rowvar=False)
    got, ref = getattr(metrics, fn)(x, y), getattr(jax_metrics, fn)(x, y)
    assert got == pytest.approx(ref, rel=REL)


def test_precision_recall_and_radii_match_jax():
    x, y = _sets(1)
    assert metrics.precision_recall(x, y, k=3) == jax_metrics.precision_recall(x, y, k=3)
    np.testing.assert_allclose(metrics.manifold_radii(x, 3), jax_metrics.manifold_radii(x, 3), rtol=REL)
    np.testing.assert_allclose(metrics.polynomial_kernel(x, y), jax_metrics.polynomial_kernel(x, y), rtol=REL)


@pytest.mark.parametrize("splits,seed", [(10, None), (3, 7)])
def test_inception_score_matches_jax(splits, seed):
    logits = np.random.RandomState(2).randn(50, 400) * 3
    got = inception_score.inception_score(logits, splits, seed)
    ref = jax_is.inception_score(logits, splits, seed)
    assert got == pytest.approx(ref, rel=REL)


def test_logmel_embedder_matches_jax():
    audio = np.random.RandomState(3).uniform(-1, 1, (3, 70560, 1)).astype(np.float32)
    got = audio_embed.LogMelEmbedder(sample_rate=44100)(audio)
    ref = jax_audio_embed.LogMelEmbedder(sample_rate=44100)(audio)
    assert got.shape == (3, 256)
    np.testing.assert_allclose(got, ref, rtol=REL)


def _tensors(rng):
    return {
        "a/w": rng.standard_normal((3, 4, 5)).astype(np.float32),
        "a/b": rng.standard_normal(7).astype(np.float64),
        "ints": rng.integers(-9, 9, (4, 4)).astype(np.int32),
        "mask": rng.random(9) > 0.5,
        "scalar": np.float32(2.5),
        **{f"many/{i:04d}": rng.standard_normal(3).astype(np.float32) for i in range(300)},  # several blocks
    }


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_bundle_round_trips_across_packages(tmp_path, writer):
    tensors = _tensors(np.random.default_rng(4))
    prefix = str(tmp_path / "variables" / "variables")
    (tf_bundle if writer == "port" else jax_bundle).write_bundle(prefix, tensors)
    for reader in (tf_bundle.BundleReader(str(tmp_path)), jax_bundle.BundleReader(str(tmp_path))):
        assert sorted(reader.keys()) == sorted(tensors)
        for k, v in tensors.items():
            got = reader.get(k)
            assert got.dtype == np.asarray(v).dtype
            np.testing.assert_array_equal(got, v)
    assert (tmp_path / "variables" / "variables.index").read_bytes() == _jax_index(tmp_path, tensors)


def _jax_index(tmp_path, tensors):
    prefix = str(tmp_path / "jax_copy" / "variables")
    jax_bundle.write_bundle(prefix, tensors)
    return open(prefix + ".index", "rb").read()


def test_crc_and_snappy_match_jax():
    data = bytes(range(256)) * 5
    assert tf_bundle.crc32c(data) == jax_bundle.crc32c(data)
    assert tf_bundle.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    assert tf_bundle.masked_crc32c(data) == jax_bundle.masked_crc32c(data)
    # a literal "abcd", then an overlapping copy of 6 from offset 2
    stream = bytes([10, (4 - 1) << 2]) + b"abcd" + bytes([((6 - 4) << 2) | 1, 2])
    assert tf_bundle.snappy_decompress(stream) == jax_bundle.snappy_decompress(stream) == b"abcdcdcdcd"
    with pytest.raises(ValueError, match="offset"):
        tf_bundle.snappy_decompress(bytes([5, 1 << 2]) + b"ab" + bytes([1, 9]))


def test_bundle_reader_reads_tensorflow_checkpoints(tmp_path):
    tf = pytest.importorskip("tensorflow")
    values = {"w": np.arange(12, dtype=np.float32).reshape(3, 4), "n": np.array([1, 2, 3], np.int64)}
    prefix = str(tmp_path / "ckpt")
    tf.raw_ops.SaveV2(prefix=prefix, tensor_names=list(values), shape_and_slices=[""] * 2,
                      tensors=[tf.constant(v) for v in values.values()])
    reader = tf_bundle.BundleReader(prefix)
    for k, v in values.items():
        np.testing.assert_array_equal(reader.get(k), v)


def test_npz_batch_files_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    videos = rng.uniform(-1, 1, (3, 8, 32, 32, 3)).astype(np.float32)
    audios = rng.uniform(-0.5, 0.5, (3, 1600)).astype(np.float32)
    extra = {"video_base": rng.uniform(-1, 1, (3, 8, 8, 8, 3)).astype(np.float32)}
    got = npz_batch.save_av_npz_batch(str(tmp_path / "port"), videos, audios, 8, 1600, extra)
    ref = jax_npz.save_av_npz_batch(str(tmp_path / "jax"), videos, audios, 8, 1600, extra)
    with np.load(got) as g, np.load(ref) as r:
        assert sorted(g.files) == sorted(r.files)
        for k in r.files:
            assert g[k].dtype == r[k].dtype and g[k].shape == r[k].shape
            np.testing.assert_array_equal(g[k], r[k])
    for a, b in zip(npz_batch.load_av_npz_batch(ref), jax_npz.load_av_npz_batch(got)):
        np.testing.assert_array_equal(a, b)
    assert npz_batch.npz_batch_len(got) == jax_npz.npz_batch_len(ref) == 3


def test_npz_loader_matches_jax(tmp_path):
    """Short clips padded by their last frame, 32x48 frames resized and
    padded to 224^2, 16 kHz audio polyphase-resampled to 44.1 kHz."""
    rng = np.random.default_rng(6)
    path = jax_npz.save_av_npz_batch(str(tmp_path / "b"), rng.uniform(-1, 1, (3, 9, 32, 48, 3)),
                                     rng.uniform(-0.5, 0.5, (3, 16000)), 10, 16000)
    args = dict(batch_size=2, video_size=(16, 3, 224, 224), audio_size=(1, 70560), audio_fps=44100)
    port, ref = npz_batch.npz_av_loader(path, **args, device="cpu"), jax_npz.npz_av_loader(path, **args)
    for _ in range(2):  # the second batch wraps around the 3 clips
        got, want = next(port), next(ref)
        assert got["video"].shape == want["video"].shape == (2, 16, 224, 224, 3)
        assert np.abs(got["video"] - want["video"]).max() <= 1 / 127.5 + 1e-6
        np.testing.assert_array_equal(got["audio"], want["audio"])


@pytest.mark.parametrize("shape", [(2, 3, 64, 64, 3), (1, 2, 48, 80, 3), (1, 2, 256, 256, 3)])
def test_i3d_preprocessing_matches_jax(shape):
    videos = np.random.RandomState(7).randint(0, 256, shape).astype(np.uint8)
    got = metrics.preprocess_videos_for_i3d(videos).numpy()
    ref = jax_metrics.preprocess_videos_for_i3d(videos)
    assert got.shape == ref.shape == shape[:2] + (224, 224, 3)
    assert np.abs(got - ref).max() <= 2 / 255 + 1e-6
