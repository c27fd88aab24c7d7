"""Tiny configurations of the benchmark's cells for the CPU tests: every
width cut so that a run takes seconds on the CPU, the port on its plain
paths in float32."""

from __future__ import annotations

import copy

from benchmark import run

MM = {"video_size": "4,3,16,16", "audio_size": "1,1024", "num_channels": 32, "num_res_blocks": 1,
      "channel_mult": "1,2,3,4", "num_heads": 2, "num_head_channels": 16,
      "cross_attention_resolutions": "2,4,8", "cross_attention_windows": "1,4,8",
      "cross_attention_shift": True, "video_attention_resolutions": "2,4,8",
      "audio_attention_resolutions": "-1", "use_scale_shift_norm": True, "resblock_updown": True,
      "learn_sigma": False, "dropout": 0.1, "video_type": "2d+1d", "use_fp16": False}
SR = {"large_size": 64, "small_size": 16, "sr_num_channels": 32, "sr_num_res_blocks": 1,
      "sr_attention_resolutions": "4,8", "sr_num_heads": 4, "sr_num_head_channels": 16,
      "sr_use_scale_shift_norm": True, "sr_resblock_updown": True, "sr_learn_sigma": True,
      "sr_dropout": 0.0, "use_fp16": False}


def spec() -> dict:
    return run.load_json(run.ROOT / "BENCHMARK.json")


def cell(workload: str):
    """(configuration, traffic) of ``workload`` at the tiny sizes."""
    _, config, traffic = run.cell_files(spec(), workload)
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    config["model"] = SR if traffic["driver"] == "sample_sr" else MM
    if traffic["driver"] == "sample_sr":
        traffic.update(frames=2, steps=3)
    if traffic["driver"] == "sample_base":
        traffic["batch"] = min(int(traffic["batch"]), 2)
    return config, traffic
