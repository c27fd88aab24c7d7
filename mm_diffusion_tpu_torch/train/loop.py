"""The training loop (counterpart of ``mm_diffusion_tpu/train/loop.py``) on
one device, or one device per rank of a ``(data, fsdp)`` mesh
(``parallel/``: DDP, or FSDP2 with ``n_fsdp > 1``): resume, the train
step, logging and save intervals, EMA-weight previews.  On a mesh every
rank runs the step on its own batch; rank 0 alone logs, writes the
checkpoints (gathered from every rank's shards) and samples the previews,
while the others wait.  What depends on the model -- the batch adapter
of the train step and the preview -- is the task's (``train/tasks.py``):
the MM-UNet by default, the SR U-Net, or a single-modal U-Net.

The data feed runs one batch ahead: a thread stages the next numpy batch in
pinned host memory and copies it to the card with ``non_blocking=True`` on
a stream of its own while the current step computes; the step's stream
waits on that copy's event.  Metrics stay on the device between log
intervals, so only a log interval synchronises with the card.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from ..diffusion.gaussian import GaussianDiffusion
from ..parallel.mesh import ParallelModel
from ..utils import logger as kvlogger
from ..utils.seeds import derive_seed
from .checkpoint import latest_checkpoint_step, restore_checkpoint, save_checkpoint
from .resample import create_named_schedule_sampler
from .state import create_train_state, make_optimizer, make_train_step
from .tasks import MultimodalTask


def parse_ema_rates(ema_rate) -> Sequence[float]:
    """Comma-separated EMA rates, e.g. ``"0.9999,0.999"``."""
    if isinstance(ema_rate, (int, float)):
        return (float(ema_rate),)
    return tuple(float(x) for x in str(ema_rate).split(","))


class _DevicePrefetcher:
    """Yields device batches one batch ahead of the caller; a loader error is
    raised on the caller's thread.  ``close()`` stops the thread."""

    _END = object()

    def __init__(self, data: Iterator[Dict[str, np.ndarray]], device: torch.device, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._data = data
        self._device = device
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, name="mmdiff-prefetch", daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _stage(self, batch):
        host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        if self._stream is None:
            return {k: v.to(self._device) for k, v in host.items()}, None
        with torch.cuda.stream(self._stream):
            dev = {k: v.pin_memory().to(self._device, non_blocking=True) for k, v in host.items()}
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return dev, ready

    def _worker(self):
        try:
            for batch in self._data:
                if not self._put(self._stage(batch)):
                    return
        except Exception as e:  # surface loader errors on the main thread
            self._put(e)
            return
        self._put(self._END)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._END:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        dev, ready = item
        if ready is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(ready)
            for v in dev.values():
                v.record_stream(stream)
        return dev


class TrainLoop:
    """Training loop.  ``data`` yields numpy batches in [-1, 1] of the
    task's layout (``MultimodalTask``: ``{"video": [B,F,H,W,C], "audio":
    [B,L,C]}``); ``model`` is moved to ``device`` and trained in place.
    ``use_db`` streams the logged scalars and each preview's media to
    wandb when it is installed (project and run name from ``output_dir``).
    ``mesh`` (``parallel.make_mesh``) trains on every rank of it, ``data``
    then being this rank's batches; ``fsdp_min_size`` is the FSDP
    placement rule's threshold.  ``close()`` stops the data feed's
    thread."""

    def __init__(
        self,
        *,
        model,
        diffusion: GaussianDiffusion,
        data: Iterator[Dict[str, np.ndarray]],
        lr: float = 1e-4,
        ema_rate="0.9999",
        log_interval: int = 100,
        save_interval: int = 10000,
        output_dir: str = "./output",
        resume_checkpoint: Optional[str] = None,
        weight_decay: float = 0.0,
        lr_anneal_steps: int = 0,
        schedule_sampler: str = "uniform",
        accum_steps: int = 1,
        seed: int = 0,
        sample_fn: str = "dpm_solver",
        save_preview: bool = True,
        preview_samples: int = 4,
        task=None,
        use_db: bool = False,
        device="cuda",
        mesh=None,
        fsdp_min_size: int = 2**18,
    ):
        self.task = task if task is not None else MultimodalTask()
        self.device = torch.device(device)
        self.model = model.to(self.device).train()
        self.diffusion = diffusion.to(self.device)
        self.data = data
        self.log_interval = log_interval
        self.save_interval = save_interval
        self.output_dir = output_dir
        self.sample_fn_name = sample_fn
        self.save_preview = save_preview
        self.preview_samples = preview_samples
        self.last_batch = None  # the last step's device batch, for the SR preview
        self.history = []  # every dumped log row
        self._prefetch = None
        self.parallel = ParallelModel(self.model, mesh, fsdp_min_size)
        self.is_main = self.parallel.rank == 0
        if use_db and self.is_main:
            out_abs = os.path.abspath(output_dir)
            kvlogger.get_current().enable_wandb(
                project=os.path.basename(os.path.dirname(out_abs)) or "mm_diffusion_tpu",
                name=os.path.basename(out_abs),
            )

        optimizer = make_optimizer(self.model, lr, weight_decay, lr_anneal_steps)
        sampler = create_named_schedule_sampler(schedule_sampler, diffusion.num_timesteps)
        self.state = create_train_state(
            self.model, optimizer, parse_ema_rates(ema_rate), sampler=sampler, parallel=self.parallel
        )
        self.ckpt_dir = os.path.join(output_dir, "checkpoints")
        resume_dir = resume_checkpoint or self.ckpt_dir
        self.resumed_from = self.parallel.from_rank0(lambda: latest_checkpoint_step(resume_dir))
        if self.resumed_from is not None:
            kvlogger.log(f"resuming from {resume_dir} step {self.resumed_from}")
            restore_checkpoint(resume_dir, self.state, self.resumed_from)
        self.seed = seed
        self.t_generator = torch.Generator()
        self.shift_generator = torch.Generator()
        self.noise_generator = torch.Generator(device=self.device)
        self._seed(self.state.step)
        self._train_step = make_train_step(
            self.diffusion, accum_steps, adapter=self.task.adapter(self)
        )

    def _seed(self, step: int) -> None:
        """Seed the generators of the timesteps and shifts (host), the noise
        (device) and dropout (torch's default generators) for ``step``, from
        the run's seed and the step alone: a resumed run draws what an
        uninterrupted one does.  The first three are alike on every rank
        (they draw for the global batch); dropout's key holds the rank too,
        so that no rank repeats another's masks at any step."""
        torch.manual_seed(derive_seed(self.seed, step, 0, self.parallel.rank))
        self.t_generator.manual_seed(derive_seed(self.seed, step, 1))
        self.shift_generator.manual_seed(derive_seed(self.seed, step, 2))
        self.noise_generator.manual_seed(derive_seed(self.seed, step, 3))

    def run_loop(self, max_steps: Optional[int] = None) -> None:
        """Train until ``max_steps`` (counted from step 0, so a resumed run
        stops at the same step) or the data ends; then save."""
        log = kvlogger.get_current()
        step = self.state.step
        pending = []
        if self._prefetch is None:
            self._prefetch = _DevicePrefetcher(self.data, self.device)

        def flush():
            for m in pending:  # the first .item() waits for the card
                log.logkvs_mean({k: v.item() for k, v in m.items()})
            pending.clear()

        t_last, since = time.perf_counter(), 0
        try:
            while max_steps is None or step < max_steps:
                with log.profile_kv("data"):
                    batch = next(self._prefetch)
                self.last_batch = batch
                self._seed(step)
                pending.append(self._train_step(
                    self.state, batch, t_generator=self.t_generator,
                    noise_generator=self.noise_generator,
                ))
                step += 1
                since += 1
                if step % self.log_interval == 0:
                    flush()
                    now = time.perf_counter()
                    log.logkv("step", step)
                    log.logkv("steps_per_sec", since / (now - t_last))
                    log.logkv("step_ms", 1000.0 * (now - t_last) / since)
                    t_last, since = now, 0
                    self.history.append(log.dumpkvs())
                if step % self.save_interval == 0:
                    self.save()
                    if self.save_preview:
                        try:
                            self.sample_preview(step)
                        except Exception as e:  # a preview must never stop training
                            log.log(f"preview sampling failed: {e}")
                        self.parallel.barrier()
        finally:
            flush()
        if self.parallel.from_rank0(lambda: latest_checkpoint_step(self.ckpt_dir)) != self.state.step:
            self.save()

    # ------------------------------------------------------------------
    def save(self) -> None:
        """Save a checkpoint (every rank gathers, rank 0 writes)."""
        step = save_checkpoint(self.ckpt_dir, self.state)
        kvlogger.log(f"saved checkpoint step {step} -> {self.ckpt_dir}")

    def sample_preview(self, step: int) -> Optional[str]:
        """The task's EMA-weight preview (on rank 0; the other ranks help
        gather the EMA weights and return None); its primary media file is
        streamed to wandb when ``use_db`` is on."""
        path = self.task.preview(self, step)
        if path:
            kvlogger.get_current().log_media(path, step=step)
        return path

    def close(self) -> None:
        if self._prefetch is not None:
            self._prefetch.close()
            self._prefetch = None
