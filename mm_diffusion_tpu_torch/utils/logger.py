"""Key-value metric logger (the port's own copy of
``mm_diffusion_tpu/utils/logger.py``: the standard library, with
TensorBoard's writer and wandb imported only when asked for; on several
ranks only rank 0 logs).

Functional re-design of the vendored OpenAI-baselines logger the reference
carries (`mm_diffusion/logger.py`, 496 LoC of global-state KV machinery).
Provides the same capabilities — logkv / logkv_mean accumulation, dumping to
human-readable stdout + JSONL + CSV (+ TensorBoard), per-process log files,
`profile_kv` wall-clock scopes, and optional wandb streaming of scalars and
preview media — as one small class with no globals required (a module
default instance keeps the reference's convenience API).
"""

from __future__ import annotations

import contextlib
import csv
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional


class KVLogger:
    def __init__(
        self,
        log_dir: Optional[str] = None,
        suffix: str = "",
        stdout: bool = True,
        tensorboard: bool = False,
    ):
        self._sums: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        self._vals: Dict[str, float] = {}
        self.stdout = stdout
        self.log_dir = log_dir
        self._jsonl = None
        self._csv_path = None
        self._csv_keys = None
        self._tb = None
        self._tb_step = 0
        self._wandb = None  # set by enable_wandb when the package imports
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, f"progress{suffix}.jsonl"), "a")
            self._csv_path = os.path.join(log_dir, f"progress{suffix}.csv")
            if tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                except ImportError:  # the TensorBoard package is optional
                    self._tb = None
                else:
                    self._tb = SummaryWriter(os.path.join(log_dir, "tb"))

    def logkv(self, key: str, val):
        self._vals[key] = float(val)

    def logkv_mean(self, key: str, val, count: int = 1):
        self._sums[key] += float(val) * count
        self._counts[key] += count

    def logkvs(self, d: Dict[str, float]):
        for k, v in d.items():
            self.logkv(k, v)

    def logkvs_mean(self, d: Dict[str, float]):
        for k, v in d.items():
            self.logkv_mean(k, v)

    def getkvs(self) -> Dict[str, float]:
        out = dict(self._vals)
        for k in self._sums:
            out[k] = self._sums[k] / max(1, self._counts[k])
        return out

    def dumpkvs(self) -> Dict[str, float]:
        kvs = self.getkvs()
        if self.stdout and kvs:
            width = max(len(k) for k in kvs)
            lines = ["-" * (width + 22)]
            for k in sorted(kvs):
                v = kvs[k]
                lines.append(f"| {k:<{width}} | {v:<15.6g} |")
            lines.append(lines[0])
            print("\n".join(lines), flush=True)
        if self._jsonl and kvs:
            self._jsonl.write(json.dumps(kvs) + "\n")
            self._jsonl.flush()
        if self._csv_path and kvs:
            self._dump_csv(kvs)
        if self._tb is not None and kvs:
            step = int(kvs.get("step", self._tb_step))
            self._tb_step = step + 1
            for k, v in kvs.items():
                self._tb.add_scalar(k, v, step)
            self._tb.flush()
        if self._wandb is not None and kvs:
            # the scalars of each log interval, at the logged step
            step = kvs.get("step")
            self._wandb.log(kvs, step=None if step is None else int(step))
        self._vals.clear()
        self._sums.clear()
        self._counts.clear()
        return kvs

    def _dump_csv(self, kvs):
        """Append a row; when NEW keys appear the whole file is rewritten
        with the widened header (parity: CSVOutputFormat.writekvs,
        reference logger.py:150-180 — r1 silently dropped late keys)."""
        extra = sorted(set(kvs) - set(self._csv_keys or []))
        if self._csv_keys is None:
            self._csv_keys = sorted(kvs)
            with open(self._csv_path, "w", newline="") as f:
                csv.writer(f).writerow(self._csv_keys)
        elif extra:
            self._csv_keys = self._csv_keys + extra
            rows = []
            if os.path.exists(self._csv_path):
                with open(self._csv_path, newline="") as f:
                    reader = csv.reader(f)
                    old_keys = next(reader, [])
                    rows = [dict(zip(old_keys, r)) for r in reader]
            with open(self._csv_path, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(self._csv_keys)
                for r in rows:
                    w.writerow([r.get(k, "") for k in self._csv_keys])
        with open(self._csv_path, "a", newline="") as f:
            csv.writer(f).writerow([kvs.get(k, "") for k in self._csv_keys])

    def log(self, *args):
        if self.stdout:
            print(*args, flush=True)

    # -- optional wandb dashboard streaming (the reference's use_db flag) --

    def enable_wandb(self, project: str, name: Optional[str] = None, config=None) -> bool:
        """Attach a wandb run as an extra sink.  The package is optional: a
        missing install degrades to the JSONL/CSV/TensorBoard sinks with a
        notice instead of failing."""
        try:
            import wandb
        except ImportError:
            self.log(
                "use_db requested but wandb is not installed — "
                "dashboard streaming disabled (JSONL/CSV/previews still on disk)"
            )
            return False
        wandb.init(project=project, name=name, config=config,
                   job_type="training", reinit=True)
        self._wandb = wandb
        return True

    def log_media(self, path: str, key: str = "sample", step: Optional[int] = None) -> bool:
        """Stream a preview media file (video, image or audio by extension).
        No-op unless enable_wandb succeeded and the file exists."""
        if self._wandb is None or not os.path.exists(path):
            return False
        lower = path.lower()
        if lower.endswith((".gif", ".mp4")):
            obj = self._wandb.Video(path)
        elif lower.endswith((".jpg", ".jpeg", ".png")):
            obj = self._wandb.Image(path)
        elif lower.endswith(".wav"):
            obj = self._wandb.Audio(path)
        else:
            return False
        self._wandb.log({key: obj}, step=step)
        return True

    @contextlib.contextmanager
    def profile_kv(self, name: str):
        """Wall-clock scope accumulated as wait_<name>
        (parity: logger.py:294-318)."""
        t0 = time.time()
        try:
            yield
        finally:
            self.logkv_mean(f"wait_{name}", time.time() - t0)

    def profile(self, name: str):
        def decorator(fn):
            def wrapped(*a, **kw):
                with self.profile_kv(name):
                    return fn(*a, **kw)

            return wrapped

        return decorator


# Module-level default instance (reference-style convenience API).
_default = KVLogger()


def configure(log_dir: Optional[str] = None, suffix: str = "", stdout: bool = True,
              tensorboard: bool = False):
    """The default logger's sinks.  On a rank other than 0 of a process
    group it gets none: only rank 0 prints and writes files."""
    global _default
    from ..parallel.mesh import process_data_shard

    if process_data_shard()[0] != 0:
        _default = KVLogger(None, suffix, stdout=False)
    else:
        _default = KVLogger(log_dir, suffix, stdout, tensorboard)
    return _default


def get_current() -> KVLogger:
    return _default


def logkv(key, val):
    _default.logkv(key, val)


def logkv_mean(key, val, count=1):
    _default.logkv_mean(key, val, count)


def dumpkvs():
    return _default.dumpkvs()


def log(*args):
    _default.log(*args)
