"""The yardstick's counts: the model FLOPs of both U-Nets at the cells'
shapes and the attention sites' work, on the CPU (meta device)."""

from __future__ import annotations

import pytest

from benchmark import run, work

JAX_BASE_PER_CLIP_EVAL = 1.468e12  # the JAX package's cost analysis (its root bench.py)
JAX_SR_PER_CLIP_EVAL = 20.11e12


def flags(name: str) -> dict:
    return run.load_json(run.BENCH / "configs" / f"{name}.json")["model"]


def test_mm_flops_match_the_ports_own_count():
    """The port's count of one base evaluation (FlopCounterMode over the
    port with its plain attention, 0.9052 of the JAX constant); the
    yardstick counts the attention from its shapes and gets the same."""
    flops, sites = work.mm_eval_work(flags("mmunet-base"), 1)
    assert flops / JAX_BASE_PER_CLIP_EVAL == pytest.approx(0.9052, abs=5e-5)
    assert len([s for s in sites if s[0] == "self"]) == 36
    assert len([s for s in sites if s[0] == "banded" and s[7] == 1]) == 10
    assert len([s for s in sites if s[0] == "banded" and s[7] > 1]) == 22
    flops8, _ = work.mm_eval_work(flags("mmunet-base"), 8)
    assert flops8 == pytest.approx(8 * flops, rel=1e-12)


def test_sr_flops_match_the_ports_own_count():
    flops, sites = work.sr_eval_work(flags("sr-unet-256"), 16)
    assert flops / JAX_SR_PER_CLIP_EVAL == pytest.approx(1.0051, abs=5e-5)
    assert len(sites) == 16 and all(s[0] == "self" for s in sites)


def test_site_work_counts_needed_bytes_only():
    # self-attention, N=2, T=16, C=128, H=2 (d=64)
    f, b = work.site_work(("self", 2, 16, 128, 2))
    assert f == 4 * 2 * 2 * 16 * 16 * 64
    assert b == 2 * 16 * (3 * 128 + 128) * 2
    fb, bb = work.site_work(("self", 2, 16, 128, 2), backward=True)
    assert fb == 2 * f and bb == 2 * 16 * 7 * 128 * 2
    # banded: the backward writes the q lanes' and the k|v lanes' gradients only
    n, fr, tq, tk, c, h, lw = 1, 16, 1024, 100, 256, 4, 4
    f, b = work.site_work(("banded", n, fr, tq, tk, c, h, lw))
    assert f == 4 * n * fr * h * tq * lw * tk * (c // h)
    assert b == (n * fr * tq * c + n * fr * tk * 2 * c + n * fr * tq * c) * 2
    _, bb = work.site_work(("banded", n, fr, tq, tk, c, h, lw), backward=True)
    assert bb == (2 * n * fr * tq * c + 2 * n * fr * tk * 2 * c + n * fr * tq * c) * 2


def test_bound_is_the_larger_time():
    assert work.bound_s(989e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert work.bound_s(989e12, 6.7e12) == pytest.approx(2.0)
