"""The port's GraphDef executor (evaluation/graphdef.py, torch ops) against
TensorFlow's own run and the JAX package's executor, on frozen graphs that
real TensorFlow builds (tests/test_graphdef.py's builders): the legacy
ResizeBilinear grid, SAME average pooling's counts, the legacy batch norm,
the mini inception graph end to end with the batch-1 Reshape relaxed, the
InceptionV3Features contract, the remaining ops, and an unknown op.

Limit: rtol 1e-4, atol 1e-5 (tests/test_graphdef.py)."""

import numpy as np
import pytest
import torch

from mm_diffusion_tpu.evaluation import graphdef as jax_graphdef
from mm_diffusion_tpu_torch.evaluation import graphdef
from test_graphdef import _bake_legacy_bn, _freeze, _import_for_oracle, _mini_inception, _run_tf, tf, tf1
from torch_port_common import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)


def _run_both(blob, fetches, feeds):
    got = [torch.as_tensor(y).numpy() for y in graphdef.GraphDefExecutor(blob).run(fetches, feeds)]
    ref = [np.asarray(y) for y in jax_graphdef.GraphDefExecutor(blob).run(fetches, feeds)]
    return got, ref


@pytest.mark.parametrize("align", [False, True])
def test_resize_bilinear_legacy_grid(align):
    img = np.random.default_rng(0).random((2, 37, 53, 3)).astype(np.float32)
    graph, blob = _freeze(lambda: tf.raw_ops.ResizeBilinear(
        images=tf1.placeholder(tf.float32, [None, None, None, 3], name="x"),
        size=tf.constant([299, 299], tf.int32), align_corners=align, name="resized"))
    (got,), (ref,) = _run_both(blob, ["resized:0"], {"x:0": img})
    np.testing.assert_allclose(got, _run_tf(graph, "resized:0", {"x:0": img}), **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("kind,padding", [("AvgPool", "SAME"), ("AvgPool", "VALID"), ("MaxPool", "SAME"),
                                          ("MaxPool", "VALID")])
def test_pools(kind, padding):
    x = np.random.default_rng(1).standard_normal((2, 11, 13, 4)).astype(np.float32)
    op = getattr(tf.raw_ops, kind)
    graph, blob = _freeze(lambda: op(**{"value" if kind == "AvgPool" else "input":
                                        tf1.placeholder(tf.float32, [None, 11, 13, 4], name="x")},
                                     ksize=[1, 3, 3, 1], strides=[1, 2, 2, 1], padding=padding, name="pool"))
    (got,), (ref,) = _run_both(blob, ["pool:0"], {"x:0": x})
    np.testing.assert_allclose(got, _run_tf(graph, "pool:0", {"x:0": x}), **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("scale_after", [True, False])
def test_legacy_batch_norm_global_normalization(scale_after):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 5, 8)).astype(np.float32)
    vals = {"m": rng.standard_normal(8), "v": rng.random(8) + 0.5, "beta": rng.standard_normal(8),
            "gamma": rng.standard_normal(8)}

    graph = tf1.Graph()
    with graph.as_default():
        xin = tf1.placeholder(tf.float32, [None, 5, 5, 8], name="x")
        for nm, val in vals.items():
            tf.constant(val.astype(np.float32), name=f"bn_{nm}")
        tf.raw_ops.Identity(input=xin, name="bn")
    gdef = _bake_legacy_bn(graph.as_graph_def(), "bn", scale_after=scale_after)
    (got,), (ref,) = _run_both(gdef.SerializeToString(), ["bn:0"], {"x:0": x})
    np.testing.assert_allclose(got, _run_tf(_import_for_oracle(gdef), "bn:0", {"x:0": x}), **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


def test_remaining_ops():
    """Conv2D SAME with an odd total pad at stride 2, FusedBatchNormV3,
    Pad, ConcatV2, MatMul with transposes, Relu6, Cast, Squeeze, RealDiv,
    Maximum / Minimum, Shape."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 10, 3)).astype(np.float32)
    w = (rng.standard_normal((4, 4, 3, 6)) * 0.3).astype(np.float32)
    stats = [rng.standard_normal(6).astype(np.float32) for _ in range(3)] + [(rng.random(6) + 0.5).astype(np.float32)]
    wm = rng.standard_normal((12, 5)).astype(np.float32)

    def build():
        xin = tf1.placeholder(tf.float32, [None, 9, 10, 3], name="x")
        y = tf.raw_ops.Conv2D(input=xin, filter=tf.constant(w), strides=[1, 2, 2, 1], padding="SAME", name="conv")
        y = tf.raw_ops.FusedBatchNormV3(x=y, scale=tf.constant(stats[0]), offset=tf.constant(stats[1]),
                                        mean=tf.constant(stats[2]), variance=tf.constant(stats[3]),
                                        epsilon=1e-3, is_training=False, name="fbn")[0]
        y = tf.raw_ops.Relu6(features=tf.raw_ops.Mul(x=y, y=tf.constant(3.0)), name="relu6")
        y = tf.raw_ops.Pad(input=y, paddings=tf.constant([[0, 0], [1, 2], [0, 1], [0, 0]]), name="pad")
        y = tf.raw_ops.ConcatV2(values=[y, tf.raw_ops.Maximum(x=y, y=tf.constant(1.0))], axis=tf.constant(3),
                                name="cat")
        y = tf.raw_ops.AvgPool(value=y, ksize=[1, 8, 6, 1], strides=[1, 1, 1, 1], padding="VALID", name="gp")
        y = tf.raw_ops.Squeeze(input=y, axis=[1, 2], name="sq")
        y = tf.raw_ops.MatMul(a=tf.constant(wm), b=y, transpose_a=True, transpose_b=True, name="mm")
        y = tf.raw_ops.RealDiv(x=tf.raw_ops.Minimum(x=y, y=tf.constant(2.0)), y=tf.constant(4.0), name="div")
        tf.raw_ops.Cast(x=tf.raw_ops.Shape(input=y), DstT=tf.float32, name="dims")
        tf.raw_ops.Softmax(logits=y, name="out")

    graph, blob = _freeze(build)
    fetches = ["out:0", "dims:0"]
    got, ref = _run_both(blob, fetches, {"x:0": x})
    oracle = _run_tf(graph, fetches, {"x:0": x})
    for g, r, o in zip(got, ref, oracle):
        np.testing.assert_allclose(np.asarray(g, np.float32), o, **TOL)
        np.testing.assert_allclose(np.asarray(g, np.float32), r, **TOL)


def test_mini_inception_end_to_end_and_batch_relaxation():
    rng = np.random.default_rng(3)
    graph, blob = _mini_inception(rng)
    imgs = (rng.random((3, 31, 41, 3)) * 255).astype(np.float32)
    fetches = ["softmax:0", "pool_3:0", "mixed_6/conv:0"]
    oracle = [_run_tf(graph, fetches, {"ExpandDims:0": imgs[i : i + 1]}) for i in range(3)]
    got, ref = _run_both(blob, fetches, {"ExpandDims:0": imgs})  # the whole batch through a batch-1 graph
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g, np.concatenate([o[i] for o in oracle]), **TOL)
        np.testing.assert_allclose(g, r, **TOL)


def test_inception_features_contract(tmp_path):
    rng = np.random.default_rng(4)
    _, blob = _mini_inception(rng)
    pb = tmp_path / "classify_image_graph_def.pb"
    pb.write_bytes(blob)
    feats = graphdef.InceptionV3Features(str(pb), device="cpu")
    jax_feats = jax_graphdef.InceptionV3Features(str(pb))
    imgs = (rng.random((5, 31, 41, 3)) * 255).astype(np.float32)
    for got, ref in zip(feats.features(imgs), jax_feats.features(imgs)):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, **TOL)
    acts = rng.random((5, 16)).astype(np.float32)
    np.testing.assert_allclose(feats.softmax(acts), jax_feats.softmax(acts), rtol=1e-6)
    preds = rng.dirichlet(np.ones(13), size=11)
    assert graphdef.inception_score_openai(preds, 4) == pytest.approx(
        jax_graphdef.inception_score_openai(preds, 4), rel=1e-10)


def test_unknown_op_raises_by_name():
    _, blob = _freeze(lambda: tf.raw_ops.Erf(x=tf1.placeholder(tf.float32, [2], name="x"), name="erf"))
    with pytest.raises(NotImplementedError, match="Erf"):
        graphdef.GraphDefExecutor(blob).run(["erf:0"], {"x:0": np.zeros(2, np.float32)})


def test_chip_smoke_graph_is_a_tensorflow_graph():
    """chip_smoke.py phase 11.1's graph, written with the port's proto
    writers, imports into TensorFlow and runs there as in the executor."""
    import chip_smoke

    blob = chip_smoke.eval_graph_bytes(6)
    graph = _import_for_oracle(tf1.GraphDef.FromString(blob))
    x = np.random.default_rng(7).uniform(0, 255, (3, 37, 45, 3)).astype(np.float32)
    (got,), (ref,) = _run_both(blob, ["out:0"], {"x:0": x})
    assert got.shape == (3, 10)
    np.testing.assert_allclose(got, _run_tf(graph, "out:0", {"x:0": x}), **TOL)
    np.testing.assert_allclose(got, ref, **TOL)
