"""DiffusionModel holder and training step (counterpart of
cleandiffuser_tpu/diffusion/basic.py).

The reference keeps one immutable pytree of parameters plus an EMA copy;
here both are `nn.ModuleDict({"diffusion": backbone, "condition":
encoder})` on one device (the CUDA device unless the caller names
another), and the pure `apply_*` helpers take either of them as their
`params`. A classifier for guidance (classifier/base.py) holds its own
parameters, optimizer and EMA; the engine keeps it in its `classifier` slot.

Training (`update`): loss (the engine's `loss_fn`), backward, AdamW with
optional global-norm clipping and a schedule (utils/train_state.py), then
the EMA step, all in place on the device. `update` returns the loss and the
gradient's global norm before clipping as device tensors: no host sync per
step. Random draws come from `self.generator` (on the engine's device,
seeded by `rng`) unless the caller passes them explicitly (`noise=`).

bf16 (`bf16_sampling`, `bf16_training`; class attributes, so the config
keys that `parallel/integrate.py` `setup_mesh` reads reach every engine, as
in the reference): the backbone's forward runs on bf16 params with its
input and condition embedding cast to bf16, and its prediction is cast back
to f32, so solver and loss math stay f32. In training the cast is
differentiable (`torch.func.functional_call` on `bf16_cast`), so the
gradients arrive f32 at the f32 master weights; optimizer state and EMA
stay f32. Ported for `DiT1d` backbones, whose blocks run K1's BF16 route on
the card; another backbone with a flag set raises.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from ..nn_condition.base import IdentityCondition
from ..nn_diffusion.dit import DiT1d
from ..utils.jax_params import load_agent_moments, load_agent_params
from ..utils.tensors import default_device
from ..utils.train_state import (
    ema_update,
    load_jax_checkpoint,
    load_state,
    make_optimizer,
    save_state,
)

__all__ = ["DiffusionModel", "bf16_cast", "pick_cfg_mode"]


def pick_cfg_mode(w_cfg: float, condition_cfg) -> str:
    """The CFG mode the reference's `sample` picks: "mix" for a weight other
    than 0 and 1, "uncond" for 0 or no condition, else "cond"."""
    if w_cfg != 0.0 and w_cfg != 1.0 and condition_cfg is not None:
        return "mix"
    if w_cfg == 0.0 or condition_cfg is None:
        return "uncond"
    return "cond"


def bf16_cast(module: nn.Module) -> dict:
    """The module's floating params and buffers cast to bfloat16, by name
    (the reference's `bf16_cast` of a param tree): a differentiable cast, for
    `torch.func.functional_call`."""
    state = {**dict(module.named_parameters()), **dict(module.named_buffers())}
    return {k: v.to(torch.bfloat16) if v.is_floating_point() else v for k, v in state.items()}


def _is_bf16(module: nn.Module) -> bool:
    return all(p.dtype == torch.bfloat16 for p in module.parameters() if p.is_floating_point())


class DiffusionModel:
    # the network forward in bf16 when sampling / training (module note);
    # instances may override
    bf16_sampling = False
    bf16_training = False

    def __init__(
        self,
        nn_diffusion: nn.Module,
        nn_condition: Optional[nn.Module] = None,
        fix_mask=None,
        loss_weight=None,
        classifier=None,
        grad_clip_norm: Optional[float] = None,
        ema_rate: float = 0.995,
        optim_params: Optional[dict] = None,
        rng: int = 0,
        device=None,
    ):
        self.device = default_device(device)
        self.classifier = classifier
        self.ema_rate = ema_rate
        cond = nn_condition if nn_condition is not None else IdentityCondition()
        self.params = nn.ModuleDict({"diffusion": nn_diffusion, "condition": cond})
        self.params.to(self.device)
        self.ema_params = copy.deepcopy(self.params).requires_grad_(False)
        self._optim_args = dict(grad_clip_norm=grad_clip_norm,
                                **(optim_params or {"lr": 2e-4, "weight_decay": 1e-5}))
        self._optimizer = None
        self.generator = torch.Generator(device=self.device).manual_seed(rng)
        self.step = 0  # host counter of updates: reading the device's would sync
        self._bf16_copies = {}  # params -> its bf16 copy (`bf16_params`)

        def per_point(a):
            if a is None:
                return None
            return torch.as_tensor(a, dtype=torch.float32, device=self.device)[None]

        # (1, *x_shape) or None; None means "no entry pinned" / "weight 1"
        self.fix_mask = per_point(fix_mask)
        self.loss_weight = per_point(loss_weight)

    # ------------------------------------------------------------------
    # Module application helpers (pure in `params`)
    # ------------------------------------------------------------------
    def apply_condition(self, params: nn.ModuleDict, condition, mask=None,
                        train: bool = False, generator: Optional[torch.Generator] = None):
        """Run nn_condition; None passes through (backbone substitutes zeros).
        With `train`, `mask` is the keep-mask (drawn from `generator` when
        None)."""
        if condition is None:
            return None
        return params["condition"](condition, mask=mask, train=train, generator=generator)

    def apply_diffusion(self, params: nn.ModuleDict, x, t, emb, train: bool = False,
                        generator: Optional[torch.Generator] = None):
        """The backbone's prediction. A backbone with dropout (a non-zero
        `dropout` attribute) takes `train` and draws its masks from
        `generator`. With the bf16 flag of the mode set (`bf16_training`
        when `train`, else `bf16_sampling`): x and emb cast to bf16, the net
        on its params cast to bf16 (already bf16 when the sampler passes its
        bf16 copy), the prediction cast to f32."""
        net = params["diffusion"]
        if not (self.bf16_training if train else self.bf16_sampling):
            if train and getattr(net, "dropout", 0.0):
                return net(x, t, emb, train=True, generator=generator)
            return net(x, t, emb)
        if not isinstance(net, DiT1d):
            # the reference runs XLA in bf16 here; the port's other
            # backbones run f32-only kernels (K3), and a quiet switch to
            # their plain blocks would be a fallback
            raise NotImplementedError(
                f"bf16_sampling / bf16_training are ported for DiT1d backbones only, not "
                f"{type(net).__name__} (ROADMAP queue 1: bf16 for the Janner U-Net)")
        x = x.to(torch.bfloat16)
        emb = None if emb is None else emb.to(torch.bfloat16)
        if _is_bf16(net):
            out = net(x, t, emb)
        else:
            out = torch.func.functional_call(net, bf16_cast(net), (x, t, emb))
        return out.to(torch.float32)

    def cfg_pred(self, params: nn.ModuleDict, xt, t, emb, w_cfg: float, cfg_mode: str,
                 net=None):
        """The network's prediction under classifier-free guidance: "mix"
        runs [cond; uncond] in one doubled forward (the unconditional half
        on a zero embedding) and combines w*cond + (1-w)*uncond, both
        weights rounded to float32 first as the reference's are; "cond" and
        "uncond" run one forward with the embedding or without. `net(params,
        x, t, emb)` is the prediction guided (`apply_diffusion` by default;
        the EDM-family engines pass their preconditioned denoiser)."""
        net = net or self.apply_diffusion
        if cfg_mode == "mix":
            b = xt.shape[0]
            emb2 = None if emb is None else torch.cat([emb, torch.zeros_like(emb)], 0)
            pred_all = net(params, torch.cat([xt, xt], 0), torch.cat([t, t], 0), emb2)
            w = np.float32(w_cfg)
            return float(w) * pred_all[:b] + float(np.float32(1) - w) * pred_all[b:]
        if cfg_mode == "cond":
            return net(params, xt, t, emb)
        if cfg_mode == "uncond":
            return net(params, xt, t, None)
        raise ValueError(f"unknown cfg_mode {cfg_mode!r}")

    def bf16_params(self, params: nn.ModuleDict) -> nn.ModuleDict:
        """`params` (backbone and condition) cast to bf16: the sampler's
        once-per-call cast. The bf16 copy is made at the first call for
        these params and refilled by one foreach copy (rounding to nearest
        even, as the reference's `astype`) at every later one."""
        copy_ = self._bf16_copies.get(params)
        if copy_ is None:
            copy_ = copy.deepcopy(params).to(torch.bfloat16).requires_grad_(False)
            self._bf16_copies[params] = copy_
        floating = lambda m: [t for t in (*m.parameters(), *m.buffers()) if t.is_floating_point()]
        with torch.no_grad():
            torch._foreach_copy_(floating(copy_), floating(params))
        return copy_

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    @property
    def optimizer(self):
        """Built at first use: an engine whose nets hold no parameters (a
        sampler test's) never trains, and torch.optim refuses none."""
        if self._optimizer is None:
            self._optimizer = make_optimizer(self.params.parameters(), **self._optim_args)
        return self._optimizer

    def loss_fn(self, params, x0, condition=None, noise=None, generator=None,
                weighted_regression=None):
        raise NotImplementedError

    def update(self, x0, condition=None, noise=None, weighted_regression_tensor=None,
               **loss_kwargs) -> dict:
        """One gradient step + EMA step. Returns {"loss", "grad_norm"} as
        device scalars. `noise` is the loss's optional explicit draws (see
        the engine's `loss_fn`); `loss_kwargs` go to the engine's `loss_fn`
        (the rectified flow's reflow source `x1`)."""
        loss = self.loss_fn(self.params, x0, condition, noise=noise, generator=self.generator,
                            weighted_regression=weighted_regression_tensor, **loss_kwargs)
        loss.backward()
        grad_norm = self.optimizer.step()
        self.ema_update()
        self.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    def ema_update(self):
        ema_update(self.ema_params, self.params, self.ema_rate)

    # ------------------------------------------------------------------
    # Checkpoints
    # ------------------------------------------------------------------
    def save(self, path):
        save_state(path, self.params, self.ema_params, self.optimizer, self.step, self.generator)

    def load(self, path):
        self.step = load_state(path, self.params, self.ema_params, self.optimizer,
                               self.generator)

    def load_jax_checkpoint(self, path):
        """Resume from a checkpoint the JAX engine's `save` wrote: params,
        EMA, Adam moments, schedule count and step (its PRNG key has no
        counterpart here; the generator keeps its state)."""
        self.load_jax_state(load_jax_checkpoint(path))

    def load_jax_state(self, ckpt: dict):
        """`load_jax_checkpoint` from the fields of a JAX TrainState already
        read (utils/train_state.py `jax_train_state`)."""
        load_agent_params(self.params, ckpt["params"])
        load_agent_params(self.ema_params, ckpt["ema_params"])
        load_agent_moments(self.optimizer.optimizer, self.params, ckpt["mu"], ckpt["nu"],
                           ckpt["count"])
        if ckpt["schedule_count"] is not None:
            self.optimizer.set_count(ckpt["schedule_count"])
        self.step = ckpt["step"]
