"""Async (subprocess) vectorised envs (counterpart of
cleandiffuser_tpu/env/async_vector.py): gymnasium's `AsyncVectorEnv` with
shared memory, started with "spawn" so that no MuJoCo / OpenGL context is
forked. The port's batched envs (PushT, BlockPush) step on the device; this
backs host envs only, and no pipeline uses it.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

__all__ = ["make_async_vector_env"]


def make_async_vector_env(env_fns: Sequence[Callable], dummy_env_fn: Optional[Callable] = None,
                          context: str = "spawn", shared_memory: bool = True):
    """gymnasium AsyncVectorEnv over `env_fns`. gymnasium >= 1.0 probes the
    spaces inside a worker, so the parent never builds an env and
    `dummy_env_fn` is accepted for the reference's signature only."""
    import gymnasium as gym

    del dummy_env_fn
    return gym.vector.AsyncVectorEnv(list(env_fns), shared_memory=shared_memory, context=context)
