"""Plain reference of a Decision Diffuser plan (arXiv:2211.15657, as
CleanDiffuser ships it, arXiv:2406.09509).

A state-only DiT1d (adaLN-Zero blocks, Fourier time embedding, sinusoidal
token positions) predicts x0; classifier-free guidance mixes the
conditioned and unconditioned predictions as w * cond + (1 - w) * uncond,
the unconditioned half on a zero condition embedding; the first state is
pinned to the observation before the first step and after every step; the
ddpm sampler runs on the continuous linear VP-SDE; an MLP inverse dynamics
turns (s0, s1) into the action.

`spec(cfg)` names every weight with its shape and the normal it is drawn
from; the benchmark draws them and hands the same tensors to the program
and to `plan`. Weights are stored as the program stores them: dense layers
(out, in), the DiT block's products (in, out). Nothing here imports the
program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import plain


def spec(cfg: dict) -> dict:
    """name -> (shape, std, mean): every weight of the planner's EMA net,
    its condition and its inverse dynamics."""
    O, A, D, E = cfg["obs_dim"], cfg["act_dim"], cfg["d_model"], cfg["emb_dim"]
    hid = cfg["invdyn_hidden"]
    out = {}

    def dense(name, n_in, n_out):
        out[f"{name}.weight"] = ((n_out, n_in), n_in ** -0.5, 0.0)
        out[f"{name}.bias"] = ((n_out,), 0.1, 0.0)

    dense("diffusion.x_proj", O, D)
    out["diffusion.t_emb.freqs"] = ((E // 8,), cfg["fourier_scale"], 0.0)
    dense("diffusion.t_emb.dense1", 2 * (E // 8), E)
    dense("diffusion.t_emb.dense2", E, E)
    dense("diffusion.t_dense1", E, D)
    dense("diffusion.t_dense2", D, D)
    for i in range(cfg["depth"]):
        p = f"diffusion.blocks.{i}"
        for w, n_in, n_out in (("mod", D, 6 * D), ("qkv", D, 3 * D), ("o", D, D),
                               ("1", D, 4 * D), ("2", 4 * D, D)):
            out[f"{p}.w{w}"] = ((n_in, n_out), n_in ** -0.5, 0.0)
            out[f"{p}.b{w}"] = ((n_out,), 0.1, 0.0)
    dense("diffusion.final.mod", D, 2 * D)
    dense("diffusion.final.out", D, O)
    dense("condition.layers.0", 1, E)
    dense("condition.layers.1", E, E)
    dense("invdyn.l1", 2 * O, hid)
    dense("invdyn.l2", hid, hid)
    dense("invdyn.l3", hid, A)
    return out


def dit_block(w: dict, p: str, x, te, n_heads: int):
    B, H, D = x.shape
    hd = D // n_heads
    mod = F.silu(te) @ w[f"{p}.wmod"] + w[f"{p}.bmod"]
    shift1, scale1, gate1, shift2, scale2, gate2 = (m[:, None] for m in mod.chunk(6, dim=-1))
    h = plain.layer_norm(x) * (1 + scale1) + shift1
    q, k, v = (h @ w[f"{p}.wqkv"] + w[f"{p}.bqkv"]).chunk(3, dim=-1)
    q = q.reshape(B, H, n_heads, hd).transpose(1, 2)
    k = k.reshape(B, H, n_heads, hd).transpose(1, 2)
    v = v.reshape(B, H, n_heads, hd).transpose(1, 2)
    att = torch.softmax((q @ k.transpose(-1, -2)) * hd ** -0.5, dim=-1)
    o = (att @ v).transpose(1, 2).reshape(B, H, D)
    x = x + gate1 * (o @ w[f"{p}.wo"] + w[f"{p}.bo"])
    h = plain.layer_norm(x) * (1 + scale2) + shift2
    h = F.gelu(h @ w[f"{p}.w1"] + w[f"{p}.b1"], approximate="tanh")
    return x + gate2 * (h @ w[f"{p}.w2"] + w[f"{p}.b2"])


def dit(w: dict, cfg: dict, x, t, emb):
    """The DiT1d's x0 prediction of x (B, H, O) at times t (B,) under the
    condition embedding emb (B, E)."""
    B, H, _ = x.shape
    pos = plain.sinusoidal_features(torch.arange(H, device=x.device), cfg["d_model"])
    h = plain.linear(w, "diffusion.x_proj", x) + pos
    ang = t[:, None] * (2 * torch.pi * w["diffusion.t_emb.freqs"])
    te = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
    te = plain.linear(w, "diffusion.t_emb.dense2",
                      plain.mish(plain.linear(w, "diffusion.t_emb.dense1", te)))
    te = te + emb
    te = plain.mish(plain.linear(w, "diffusion.t_dense1", te))
    te = plain.mish(plain.linear(w, "diffusion.t_dense2", te))
    for i in range(cfg["depth"]):
        h = dit_block(w, f"diffusion.blocks.{i}", h, te, cfg["n_heads"])
    shift, scale = plain.linear(w, "diffusion.final.mod", F.silu(te)).chunk(2, dim=-1)
    h = plain.layer_norm(h) * (1 + scale[:, None]) + shift[:, None]
    return plain.linear(w, "diffusion.final.out", h)


def plan(w: dict, cfg: dict, obs, noise0, noise_steps):
    """One plan for observations obs (E, O) with the sampler's draws noise0
    (E, H, O) and noise_steps (steps, E, H, O). Returns (actions (E, A),
    trajectory (E, H, O))."""
    plain.check_sampler(cfg, "linear")
    E, O, H = obs.shape[0], cfg["obs_dim"], cfg["horizon"]
    steps = cfg["sampling_steps"]
    ts, alphas, sigmas = plain.continuous_tables(steps)
    stds = plain.ddpm_stds(alphas, sigmas)
    wc = float(torch.tensor(cfg["w_cfg"], dtype=torch.float32))
    prior = torch.zeros((E, H, O), device=obs.device)
    prior[:, 0] = obs
    pin = torch.zeros((1, H, O), device=obs.device)
    pin[:, 0] = 1.0
    cond = torch.full((E, 1), cfg["target_return"], device=obs.device)
    emb = plain.linear(w, "condition.layers.1", F.silu(plain.linear(w, "condition.layers.0", cond)))
    x = noise0 * cfg["temperature"]
    x = x * (1 - pin) + prior * pin
    for n, i in enumerate(range(steps, 0, -1)):
        t = torch.full((E,), float(ts[i]), device=obs.device)
        x0_cond = dit(w, cfg, x, t, emb)
        x0_uncond = dit(w, cfg, x, t, torch.zeros_like(emb))
        x0 = wc * x0_cond + (1 - wc) * x0_uncond
        eps = plain.x0_to_eps(x, float(alphas[i]), float(sigmas[i]), x0)
        x = plain.ddpm_step(x, eps, i, alphas, sigmas, stds, noise_steps[n])
        x = x * (1 - pin) + prior * pin
    oo = torch.cat([obs, x[:, 1]], dim=-1)
    h = torch.relu(plain.linear(w, "invdyn.l1", oo))
    h = torch.relu(plain.linear(w, "invdyn.l2", h))
    return torch.tanh(plain.linear(w, "invdyn.l3", h)), x
