"""A/B tools of the port: the counterparts of the JAX package's spike tools
(``tools/bench_attn_variants.py`` and ``tools/bench_attn_variants2.py``,
``tools/bench_skip_conv.py``, ``tools/conv_chw_spike.py``), each the entry
point of its hand-written kernels.  Run them as modules
(``python -m mm_diffusion_tpu_torch.tools.<name>``); ``--device`` defaults
to ``cuda`` and takes the CPU (the plain versions, host-clock times) only
when asked for."""


def check_close(out, ref, tol, label: str) -> float:
    """Max |out - ref|; exits the tool if any element is beyond the kernel's
    limit ``tol`` (an ``ops.common.Tolerance``): a kernel that disagrees
    with its plain version."""
    err, ok = tol.check(out, ref)
    if not ok:
        raise SystemExit(f"{label}: error {err:.3e} beyond {tol}")
    return err
