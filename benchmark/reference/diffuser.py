"""Plain reference of a Diffuser plan (arXiv:2205.09991, as CleanDiffuser
ships it, arXiv:2406.09509).

A Janner U-Net (channels-last residual blocks of two "same" convs, each
followed by GroupNorm and Mish, with the time embedding added after the
first; stride-2 convs down, stride-2 transposed convs up, skip connections
by concatenation) predicts x0 of the joint (state, action) trajectory. At
every ddpm step of the discrete cosine VP-SDE the half U-Net classifier's
gradient of its predicted return with respect to x is added to the
prediction with weight w_cg * sigma^2 / alpha; the first state is pinned to
the observation. Each environment's K candidates (candidate-major rows,
row k * E + e) are scored by the classifier at level 0, and the best one's
first action, clipped to [-1, 1], is the action.

`spec(cfg)` names every weight with its shape and the normal it is drawn
from (convs (K, Cin, Cout), transposed convs (Cin, Cout, 4), dense layers
(out, in)); the benchmark draws them and hands the same tensors to the
program and to `plan`. Nothing here imports the program.
"""

from __future__ import annotations

import torch

from . import plain


def _levels(cfg: dict):
    """Channel widths (in, out) of each level of the U-Net."""
    dims = [cfg["obs_dim"] + cfg["act_dim"]]
    width = cfg["model_dim"]
    for m in cfg["dim_mult"]:
        width *= m
        dims.append(width)
    return list(zip(dims[:-1], dims[1:]))


def unet_blocks(cfg: dict):
    """(horizon, c_in, c_out) of the U-Net's residual blocks in call order,
    kernel size cfg["kernel_size"] each."""
    H, levels = cfg["horizon"], _levels(cfg)
    out = []
    for ind, (ci, co) in enumerate(levels):
        out += [(H, ci, co), (H, co, co)]
        if ind < len(levels) - 1:
            H //= 2
    mid = levels[-1][1]
    out += [(H, mid, mid), (H, mid, mid)]
    for ci, co in reversed(levels[1:]):
        out += [(H, 2 * co, ci), (H, ci, ci)]
        H *= 2
    return out


def unet_resamples(cfg: dict):
    """The U-Net's stride-2 convs down, (length out, channels), and its
    transposed convs up, (length in, channels), in call order."""
    H, levels = cfg["horizon"], _levels(cfg)
    downs = [(H >> (i + 1), co) for i, (_, co) in enumerate(levels[:-1])]
    n = len(levels) - 1
    ups = [(H >> (n - i), ci) for i, (ci, _) in enumerate(reversed(levels[1:]))]
    return downs, ups


def classifier_blocks(cfg: dict):
    """(horizon, c_in, c_out, kernel) of the half U-Net's residual blocks."""
    H, levels, k = cfg["horizon"], _levels(cfg), cfg["classifier_kernel_size"]
    out = []
    for ind, (ci, co) in enumerate(levels):
        out += [(H, ci, co, k), (H, co, co, k)]
        if ind < len(levels) - 1:
            H //= 2
    mid = levels[-1][1]
    out += [(H, mid, mid // 2, 5), (H // 2, mid // 2, mid // 4, 5)]
    return out


def classifier_downs(cfg: dict):
    """(length out, channels) of the half U-Net's stride-2 convs: after each
    level but the last, and after each of its two closing blocks."""
    blocks = classifier_blocks(cfg)
    n = len(cfg["dim_mult"])
    after = [blocks[2 * i + 1] for i in range(n - 1)] + blocks[2 * n:]
    return [(h // 2, co) for h, _, co, _ in after]


def spec(cfg: dict) -> dict:
    """name -> (shape, std, mean) of the U-Net's and the classifier's EMA
    weights."""
    md, F_ = cfg["model_dim"], cfg["obs_dim"] + cfg["act_dim"]
    levels = _levels(cfg)
    out = {}

    def dense(name, n_in, n_out):
        out[f"{name}.weight"] = ((n_out, n_in), n_in ** -0.5, 0.0)
        out[f"{name}.bias"] = ((n_out,), 0.1, 0.0)

    def conv(name, k, ci, co):
        out[f"{name}.kernel"] = ((k, ci, co), (k * ci) ** -0.5, 0.0)
        out[f"{name}.bias"] = ((co,), 0.1, 0.0)

    def norm(name, c):
        out[f"{name}.scale"] = ((c,), 0.1, 1.0)
        out[f"{name}.bias"] = ((c,), 0.1, 0.0)

    def block(name, ci, co, k):
        conv(f"{name}.conv1", k, ci, co)
        norm(f"{name}.norm1", co)
        dense(f"{name}.film", md, co)
        conv(f"{name}.conv2", k, co, co)
        norm(f"{name}.norm2", co)
        if ci != co:
            conv(f"{name}.skip", 1, ci, co)

    for net in ("diffusion", "classifier"):
        dense(f"{net}.t_dense1", md, 4 * md)
        dense(f"{net}.t_dense2", 4 * md, md)
    for i, (_, ci, co) in enumerate(unet_blocks(cfg)):
        block(f"diffusion.blocks.{i}", ci, co, cfg["kernel_size"])
    for i, (_, co) in enumerate(levels[:-1]):
        conv(f"diffusion.downs.{i}.conv", 3, co, co)
    for i, (ci, _) in enumerate(reversed(levels[1:])):
        out[f"diffusion.ups.{i}.conv.weight"] = ((ci, ci, 4), (2 * ci) ** -0.5, 0.0)
        out[f"diffusion.ups.{i}.conv.bias"] = ((ci,), 0.1, 0.0)
    conv("diffusion.final_conv", 5, md, md)
    norm("diffusion.final_norm", md)
    conv("diffusion.out_conv", 1, md, F_)
    cblocks = classifier_blocks(cfg)
    for i, (_, ci, co, k) in enumerate(cblocks):
        block(f"classifier.blocks.{i}", ci, co, k)
    downs = classifier_downs(cfg)
    for i, (_, c) in enumerate(downs):
        conv(f"classifier.downs.{i}.conv", 3, c, c)
    fc = downs[-1][1] * max(downs[-1][0], 1)
    dense("classifier.head1", fc + md, fc // 2)
    dense("classifier.head2", fc // 2, 1)
    return out


def groups(c: int) -> int:
    """GroupNorm's groups over c channels."""
    return min(8, c // 4)


def res_block(w: dict, p: str, x, te):
    co = w[f"{p}.conv1.bias"].shape[0]
    e = plain.linear(w, f"{p}.film", plain.mish(te))
    h = plain.mish(plain.group_norm(w, f"{p}.norm1", plain.conv(w, f"{p}.conv1", x), groups(co)))
    h = h + e[:, None]
    h = plain.mish(plain.group_norm(w, f"{p}.norm2", plain.conv(w, f"{p}.conv2", h), groups(co)))
    return h + (plain.conv(w, f"{p}.skip", x) if f"{p}.skip.kernel" in w else x)


def _time(w: dict, net: str, cfg: dict, t):
    te = plain.positional_features(t, cfg["model_dim"])
    return plain.linear(w, f"{net}.t_dense2", plain.mish(plain.linear(w, f"{net}.t_dense1", te)))


def unet(w: dict, cfg: dict, x, t):
    """The U-Net's x0 prediction of x (B, H, O + A) at levels t (B,)."""
    te = _time(w, "diffusion", cfg, t)
    n_levels = len(cfg["dim_mult"])
    blk = iter(range(len(unet_blocks(cfg))))
    run = lambda h: res_block(w, f"diffusion.blocks.{next(blk)}", h, te)
    stack = []
    for ind in range(n_levels):
        x = run(run(x))
        stack.append(x)
        if ind < n_levels - 1:
            x = plain.conv(w, f"diffusion.downs.{ind}.conv", x, stride=2, padding=(1, 1))
    x = run(run(x))
    for i in range(n_levels - 1):
        x = run(run(torch.cat([x, stack.pop()], dim=-1)))
        x = plain.conv_transpose(w, f"diffusion.ups.{i}.conv", x)
    h = plain.mish(plain.group_norm(w, "diffusion.final_norm",
                                    plain.conv(w, "diffusion.final_conv", x),
                                    groups(cfg["model_dim"])))
    return plain.conv(w, "diffusion.out_conv", h)


def classifier(w: dict, cfg: dict, x, t):
    """The half U-Net's predicted return of x at levels t: (B, 1)."""
    te = _time(w, "classifier", cfg, t)
    n_levels = len(cfg["dim_mult"])
    down = lambda h, i: plain.conv(w, f"classifier.downs.{i}.conv", h, stride=2, padding=(1, 1))
    for ind in range(n_levels):
        x = res_block(w, f"classifier.blocks.{2 * ind}", x, te)
        x = res_block(w, f"classifier.blocks.{2 * ind + 1}", x, te)
        if ind < n_levels - 1:
            x = down(x, ind)
    for j in range(2):
        x = down(res_block(w, f"classifier.blocks.{2 * n_levels + j}", x, te), n_levels - 1 + j)
    h = torch.cat([x.reshape(x.shape[0], -1), te], dim=-1)
    return plain.linear(w, "classifier.head2", plain.mish(plain.linear(w, "classifier.head1", h)))


def classifier_grad(w: dict, cfg: dict, x, t):
    with torch.enable_grad():
        xi = x.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(classifier(w, cfg, xi, t).sum(), xi)
    return grad


def plan(w: dict, cfg: dict, obs, candidates: int, noise0, noise_steps):
    """One plan for observations obs (E, O), `candidates` trajectories each,
    with the sampler's draws noise0 (K E, H, O + A) and noise_steps (steps,
    K E, H, O + A). Returns the actions (E, A), every candidate (K, E, H,
    O + A), their log p (K, E) and the chosen candidate of each env (E,)."""
    plain.check_sampler(cfg, "cosine")
    E, O, H = obs.shape[0], cfg["obs_dim"], cfg["horizon"]
    K, F_ = candidates, cfg["obs_dim"] + cfg["act_dim"]
    steps = cfg["sampling_steps"]
    levels, alphas, sigmas = plain.discrete_tables(cfg["diffusion_steps"], steps)
    stds = plain.ddpm_stds(alphas, sigmas)
    w_cg = torch.tensor(cfg["w_cg"], dtype=torch.float32)
    prior = torch.zeros((E, H, F_), device=obs.device)
    prior[:, 0, :O] = obs
    prior = prior.repeat(K, 1, 1)
    pin = torch.zeros((1, H, F_), device=obs.device)
    pin[:, 0, :O] = 1.0
    x = noise0 * cfg["temperature"]
    x = x * (1 - pin) + prior * pin
    B = K * E
    for n, i in enumerate(range(steps, 0, -1)):
        t = torch.full((B,), int(levels[i]), dtype=torch.int32, device=obs.device)
        a, s = alphas[i], sigmas[i]
        x0 = unet(w, cfg, x, t) + float(w_cg * (s ** 2 / a)) * classifier_grad(w, cfg, x, t)
        eps = plain.x0_to_eps(x, float(a), float(s), x0)
        x = plain.ddpm_step(x, eps, i, alphas, sigmas, stds, noise_steps[n])
        x = x * (1 - pin) + prior * pin
    logp = classifier(w, cfg, x, torch.zeros((B,), dtype=torch.int32, device=obs.device))
    logp = logp.reshape(K, E)
    idx = logp.argmax(0)
    cands = x.reshape(K, E, H, F_)
    act = torch.clamp(cands[idx, torch.arange(E, device=obs.device), 0, O:], -1.0, 1.0)
    return act, cands, logp, idx
