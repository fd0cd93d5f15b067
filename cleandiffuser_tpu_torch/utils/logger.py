"""Experiment logger: JSON lines always, wandb when it is installed
(counterpart of cleandiffuser_tpu/utils/logger.py, pure Python).

    logger = Logger(save_path, args.to_dict())
    logger.log({"loss": 0.1, "gradient_steps": 1000}, "train")   # train.jsonl
    logger.finish()

`config.json` holds the run's config; each category appends one JSON object
per `log` call to `<category>.jsonl`, with the wall-clock `_time`. On a
mesh (one process per rank) only rank 0 writes: on the other ranks the
logger makes no directory, file, video path or wandb run.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional

from .ranks import is_writer

__all__ = ["Timer", "Logger"]


class Timer:
    def __init__(self):
        self._start = time.time()

    def reset(self):
        self._start = time.time()
        return self._start

    def __call__(self, reset: bool = True):
        now = time.time()
        diff = now - self._start
        if reset:
            self._start = now
        return diff


class Logger:
    def __init__(self, log_dir, config: Optional[Dict[str, Any]] = None,
                 enable_wandb: bool = False, project: str = "cleandiffuser_tpu",
                 name: Optional[str] = None):
        self.log_dir = Path(log_dir)
        self._files = {}
        self.wandb_run = None
        self.writer = is_writer()
        if not self.writer:
            return
        self.log_dir.mkdir(parents=True, exist_ok=True)
        if config is not None:
            with open(self.log_dir / "config.json", "w") as f:
                json.dump(_jsonable(config), f, indent=2)
        if enable_wandb:
            try:
                import wandb

                self.wandb_run = wandb.init(
                    project=project, name=name, dir=str(self.log_dir),
                    config=_jsonable(config or {}),
                )
            except ImportError:
                print("[Logger] wandb not available; jsonl only")

    def log(self, metrics: Dict[str, Any], category: str = "train"):
        if not self.writer:
            return
        if category not in self._files:
            self._files[category] = open(self.log_dir / f"{category}.jsonl", "a")
        f = self._files[category]
        f.write(json.dumps(_jsonable({**metrics, "_time": time.time()})) + "\n")
        f.flush()
        if self.wandb_run is not None:
            self.wandb_run.log({f"{category}/{k}": v for k, v in metrics.items()})

    def save_agent(self, agent, identifier="latest"):
        if self.writer:
            agent.save(str(self.log_dir / f"ckpt_{identifier}"))

    def video_init(self, env, enable: bool = True, video_id: str = "0"):
        """Point a video-recording env wrapper (env/wrapper.py) at
        `video_<id>.mp4` in the log directory, or switch it off; an env
        without a recorder is left as it is. Off on every rank but 0."""
        if hasattr(env, "video_recorder"):
            env.file_path = (str(self.log_dir / f"video_{video_id}.mp4")
                             if enable and self.writer else None)

    def finish(self, agent=None):
        if agent is not None:
            self.save_agent(agent, "final")
        for f in self._files.values():
            f.close()
        self._files = {}
        if self.wandb_run is not None:
            self.wandb_run.finish()


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    # one-element numpy arrays and scalars (`.size`), torch tensors (`.numel()`)
    numel = obj.numel() if hasattr(obj, "numel") else getattr(obj, "size", 2)
    if hasattr(obj, "item") and numel == 1:
        return obj.item()
    if hasattr(obj, "to_dict"):
        return _jsonable(obj.to_dict())
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)
