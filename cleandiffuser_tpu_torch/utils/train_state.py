"""Training state: optimizer, schedule, EMA and checkpoints (counterpart of
cleandiffuser_tpu/utils/train_state.py).

The reference keeps one immutable pytree (params, EMA, optax state, step,
PRNG key) and fuses loss, gradient, optimizer and EMA into one XLA program.
Here the parameters and their EMA stay two `nn.Module`s updated in place,
the optimizer is a `torch.optim` one, and every step is a handful of
`torch._foreach_*` launches with no host sync.

- `TrainOptimizer` (built by `make_optimizer`): optax's
  `chain(clip_by_global_norm?, adamw)` (decoupled decay, eps 1e-8,
  eps_root 0) as `torch.optim.AdamW`, or the classifier's
  `chain(clip?, add_decayed_weights?, adam)` (coupled L2) as
  `torch.optim.Adam(weight_decay=wd)`. A schedule is evaluated at the count
  *before* the step, as optax's `scale_by_schedule` does.
- `cosine_decay_schedule`: optax's closed form, in float32 as optax
  computes it. It runs through a `LambdaLR` on base lr 1, so the rate a step
  uses is exactly the schedule's value (`CosineAnnealingLR` is recursive and
  drifts from the closed form).
- `make_adam`: optax's `adam` (no decay, no clipping), the RL critics'
  optimizer, on a float rate or a schedule.
- `ema_update`: `e * rate + p * (1 - rate)` in that form (not `lerp`, whose
  rounding differs). The RL pipelines' two gates and their target rule:
  `ema_gate` (the actor's EMA every `interval` steps from step 1000, read
  on the host step counter, no device sync) and `target_update` (the
  critic target takes `1 - tau` of the *online* net, reference dql.py:207-212
  and idql.py:169-172; IQL's own target rule, utils/iql.py, weights the
  other way round, and each is kept where it is used).
- `save_state` / `load_state`: the port's own checkpoint (params, EMA,
  optimizer moments, schedule count, step, generator state; the dict of
  `train_state_dict`, which the RL pipelines store beside their critics');
  a resumed run continues exactly.
- `load_jax_checkpoint`: reads a pickle written by the JAX `save_state`
  (an engine's or a classifier's: SfBC's `.actor`, QGPO's
  `clf_ckpt_latest`, SynthER's `diff_ckpt_*`) without JAX, flax, optax or
  the JAX package installed; `read_jax_pickle` reads the pipelines' other
  pickles (the RL pipelines' {"actor": TrainState, "critic": ...}, SfBC's
  `.critic` and QGPO's `q_state.pkl` param trees, SynthER's `td3bc.pkl`
  `TD3BCState`), `jax_train_state` and `jax_adam_state` take their fields
  apart.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Callable, Iterable, Optional, Union

import numpy as np
import torch
import torch.nn as nn

__all__ = [
    "TrainOptimizer",
    "make_optimizer",
    "make_adam",
    "cosine_decay_schedule",
    "ema_update",
    "ema_gate",
    "target_update",
    "train_state_dict",
    "load_train_state_dict",
    "save_state",
    "load_state",
    "load_jax_checkpoint",
    "read_jax_pickle",
    "jax_train_state",
    "jax_adam_state",
]


def cosine_decay_schedule(lr: float, steps: int) -> Callable[[int], float]:
    """optax.cosine_decay_schedule(lr, steps):
    lr * 0.5 * (1 + cos(pi * min(n, steps) / steps)), in float32."""
    if steps <= 0:
        raise ValueError(f"cosine_decay_schedule needs steps > 0, got {steps}")
    f32 = np.float32

    def schedule(count: int) -> float:
        n = f32(min(count, steps))
        decay = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * n / f32(steps)))
        return float(f32(lr) * decay)

    return schedule


class TrainOptimizer:
    """Adam(W) over a fixed list of parameters, with optional global-norm
    clipping and an optional schedule. `step()` after `backward()`: it
    clips, updates in place, advances the schedule, clears the gradients and
    returns the gradient's global norm before clipping (a device scalar)."""

    def __init__(self, params: Iterable[nn.Parameter], lr: Union[float, Callable] = 2e-4,
                 weight_decay: float = 1e-5, grad_clip_norm: Optional[float] = None,
                 decoupled: bool = True):
        self.params = list(params)
        self.grad_clip_norm = grad_clip_norm
        opt_cls = torch.optim.AdamW if decoupled else torch.optim.Adam
        # a schedule runs on base lr 1, so the rate is the schedule's value
        self.optimizer = opt_cls(self.params, lr=1.0 if callable(lr) else lr,
                                 betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
        self.scheduler = (torch.optim.lr_scheduler.LambdaLR(self.optimizer, lr)
                          if callable(lr) else None)

    @property
    def count(self) -> int:
        """Steps taken (optax's schedule count)."""
        return self.scheduler.last_epoch if self.scheduler is not None else 0

    def step(self) -> torch.Tensor:
        for p in self.params:
            if p.grad is None:  # unused this step: optax sees a zero gradient
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.grad_clip_norm is not None:
            # optax clip_by_global_norm: g if norm < max else g * max / norm
            scale = torch.where(norm < self.grad_clip_norm, torch.ones_like(norm),
                                self.grad_clip_norm / norm)
            torch._foreach_mul_(grads, scale)
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        self.optimizer.zero_grad(set_to_none=True)
        return norm.detach()

    def state_dict(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.set_count(state["count"])

    def set_count(self, count: int) -> None:
        """Move the schedule to `count` steps taken."""
        if self.scheduler is not None:
            self.scheduler.last_epoch = count
            for group in self.optimizer.param_groups:
                group["lr"] = self.scheduler.lr_lambdas[0](count)


def make_optimizer(params: Iterable[nn.Parameter], lr: Union[float, Callable] = 2e-4,
                   weight_decay: float = 1e-5, grad_clip_norm: Optional[float] = None,
                   decoupled: bool = True) -> TrainOptimizer:
    """AdamW with optional global-norm clipping (the reference's defaults:
    lr 2e-4, weight decay 1e-5). `decoupled=False` gives Adam with coupled
    L2 decay (the classifier's optimizer)."""
    return TrainOptimizer(params, lr, weight_decay, grad_clip_norm, decoupled)


def make_adam(params: Iterable[nn.Parameter], lr: Union[float, Callable]) -> TrainOptimizer:
    """optax.adam(lr): Adam with no decay and no clipping."""
    return TrainOptimizer(params, lr, weight_decay=0.0, decoupled=False)


@torch.no_grad()
def ema_update(ema: nn.Module, params: nn.Module, rate: float) -> None:
    """ema <- ema * rate + params * (1 - rate), in place, over the
    parameters (buffers are frozen and equal in both)."""
    e = list(ema.parameters())
    torch._foreach_mul_(e, rate)
    torch._foreach_add_(e, torch._foreach_mul(list(params.parameters()), 1.0 - rate))


def ema_gate(step: int, interval: int, start: int = 1000) -> bool:
    """Whether the RL actors' EMA moves at host step `step` (the count of
    updates taken before this one): every `interval` steps from `start`.
    Until then the EMA actor is the initial network."""
    return step % interval == 0 and step >= start


def target_update(target: nn.Module, online: nn.Module, tau: float = 0.005) -> None:
    """target <- (1 - tau) * online + tau * target: the DQL, EDP and IDQL
    critic-target rule, which keeps `1 - tau` of the online net."""
    ema_update(target, online, tau)


def train_state_dict(params: nn.Module, ema_params: nn.Module, optimizer: TrainOptimizer,
                     step: int, generator: Optional[torch.Generator] = None) -> dict:
    """Params, EMA, optimizer state (moments and schedule count), the step
    and the generator's state, as one dict for `torch.save`."""
    return {"params": params.state_dict(), "ema_params": ema_params.state_dict(),
            "optimizer": optimizer.state_dict(), "step": step,
            "generator": None if generator is None else generator.get_state()}


def load_train_state_dict(state: dict, params: nn.Module, ema_params: nn.Module,
                          optimizer: TrainOptimizer,
                          generator: Optional[torch.Generator] = None) -> int:
    """Restore a `train_state_dict` in place; returns the step. The
    generator's state is restored when the checkpoint's comes from a
    generator of the same kind (a CUDA generator's state is its seed and
    offset, a CPU generator's the whole Mersenne state): a checkpoint
    written on the card and read on the CPU, or the other way round, keeps
    the reading generator's stream."""
    params.load_state_dict(state["params"])
    ema_params.load_state_dict(state["ema_params"])
    optimizer.load_state_dict(state["optimizer"])
    saved = state["generator"]
    if (generator is not None and saved is not None
            and saved.numel() == generator.get_state().numel()):
        generator.set_state(saved)
    return state["step"]


def save_state(path, params: nn.Module, ema_params: nn.Module, optimizer: TrainOptimizer,
               step: int, generator: Optional[torch.Generator] = None) -> None:
    """Write `train_state_dict` to one file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(train_state_dict(params, ema_params, optimizer, step, generator), path)


def load_state(path, params: nn.Module, ema_params: nn.Module, optimizer: TrainOptimizer,
               generator: Optional[torch.Generator] = None) -> int:
    """Restore a `save_state` file in place; returns the step."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return load_train_state_dict(state, params, ema_params, optimizer, generator)


# ---------------------------------------------------------------------------
# Reading the JAX package's checkpoints
#
# The JAX `save_state` pickles its TrainState (a flax.struct dataclass) with
# numpy leaves; the optimizer state inside is a tuple of optax namedtuples.
# The unpickler below maps those classes to plain stand-ins, so the file
# reads without JAX, flax or optax. It takes nothing else but numpy's arrays.

# optax state namedtuples -> their field names (clipping, decay and a
# constant scale keep an EmptyState)
_OPTAX_FIELDS = {
    "ScaleByAdamState": ("count", "mu", "nu"),
    "ScaleByScheduleState": ("count",),
    "EmptyState": (),
}
_JAX_MODULES = ("cleandiffuser_tpu", "optax", "flax", "jax")
# the flax.struct dataclasses of the JAX package's checkpoints: the engines'
# TrainState, the RL pipelines' critic states, Veteran's EV state and
# SynthER's TD3+BC state
_JAX_STATES = ("TrainState", "CriticState", "IQLCriticState", "EVState", "TD3BCState")


class _StandIn:
    """A JAX-side object read from a pickle: its class name, positional
    constructor arguments and pickled state."""

    name = ""

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj.args, obj.state = args, {}
        return obj

    def __setstate__(self, state):
        if isinstance(state, tuple):  # (dict, slots)
            state = {**(state[0] or {}), **(state[1] or {})}
        self.state = state

    def fields(self) -> dict:
        if self.name in _OPTAX_FIELDS:
            return dict(zip(_OPTAX_FIELDS[self.name], self.args))
        return dict(self.state)


# what numpy arrays and scalars pickle as
_NUMPY_NAMES = ("_reconstruct", "ndarray", "dtype", "scalar")


class _JaxUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        top = module.split(".")[0]
        if top in _JAX_MODULES and (name in _JAX_STATES or name in _OPTAX_FIELDS):
            return type(name, (_StandIn,), {"name": name})
        if top == "numpy" and name in _NUMPY_NAMES:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refusing {module}.{name} in a checkpoint")


def _plain(obj):
    """Stand-ins -> dicts of their fields, recursively; numpy leaves kept."""
    if isinstance(obj, _StandIn):
        return {"_class": obj.name, **{k: _plain(v) for k, v in obj.fields().items()}}
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(v) for v in obj)
    return obj


def _find(tree, cls_name):
    """The first stand-in of class `cls_name` in a walk of `tree`."""
    if isinstance(tree, dict):
        if tree.get("_class") == cls_name:
            return tree
        items = tree.values()
    elif isinstance(tree, (list, tuple)):
        items = tree
    else:
        return None
    for v in items:
        found = _find(v, cls_name)
        if found is not None:
            return found
    return None


def read_jax_pickle(path):
    """Unpickle a file written by the JAX package, stand-ins made plain."""
    with open(path, "rb") as f:
        return _plain(_JaxUnpickler(f).load())


def jax_adam_state(opt_state) -> dict:
    """An optax state read by `read_jax_pickle`: "mu", "nu" (the Adam
    moments, shaped as the params), "count" (Adam's) and "schedule_count"
    (None without a schedule)."""
    adam = _find(opt_state, "ScaleByAdamState")
    if adam is None:
        raise ValueError("the optimizer state has no Adam moments")
    sched = _find(opt_state, "ScaleByScheduleState")
    return {"mu": adam["mu"], "nu": adam["nu"], "count": int(adam["count"]),
            "schedule_count": None if sched is None else int(sched["count"])}


def jax_train_state(state: dict) -> dict:
    """A JAX TrainState read by `read_jax_pickle`: "params", "ema_params",
    the `jax_adam_state` fields and "step"."""
    if state.get("_class") != "TrainState":
        raise ValueError("not a JAX TrainState")
    return {"params": state["params"], "ema_params": state["ema_params"],
            **jax_adam_state(state["opt_state"]), "step": int(state["step"])}


def load_jax_checkpoint(path) -> dict:
    """Read a JAX `save_state` pickle: nested dicts of numpy arrays, as
    `jax_train_state` returns them."""
    state = read_jax_pickle(path)
    if state.get("_class") != "TrainState":
        raise ValueError(f"{path} holds no JAX TrainState")
    return jax_train_state(state)
