"""The benchmark's plain reference: a frozen copy of the port's two U-Nets,
its DDIM and DPM-Solver samplers, its diffusion loss and its AdamW / EMA
step, in plain PyTorch and float32.

It imports nothing of ``jax``, ``mm_diffusion_tpu`` or
``mm_diffusion_tpu_torch``: every table, schedule and weight it needs it
works out again from the configuration and the seed.  Parameter names are
the original MM-Diffusion ``state_dict`` keys, so one set of weights loads
into the port and into the reference alike.
"""
