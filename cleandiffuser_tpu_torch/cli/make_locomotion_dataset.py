"""Generate d4rl-style locomotion datasets on real MuJoCo-v5 physics: the
port's copy of tools/make_locomotion_dataset.py.

d4rl produced its locomotion suites by training SAC online and logging
policies at two capability levels (d4rl paper section 4):
  medium        1M steps sampled from a partly trained policy
  medium-replay the replay buffer accumulated up to the medium point
  medium-expert 1M medium + 1M fully trained policy steps, concatenated

This tool re-creates the recipe with utils/sac.py on gymnasium's -v5 envs
and writes the d4rl snapshot schema (<env>-{medium-replay,medium,
medium-expert}-v2.npz and .qlearning.npz) into `$CLEANDIFFUSER_DATA`
(pipelines/data_loading.py `data_dir()`), where the locomotion CLIs read
it in place of synthetic data. Scores against these datasets carry the
v2-against-v5 dynamics caveat (BASELINE.md).

MuJoCo steps on the host; the replay ring and every SAC update live on the
device (utils/sac.py `DeviceCollector`: one `step` per n_envs env steps
writes the new transitions, runs the K updates and picks the next
actions). Evaluation and the dataset rollouts use the host numpy actor
(`NumpyActor`). It runs on the CUDA device, or on the CPU with
`--platform cpu`.

Usage:
    python -m cleandiffuser_tpu_torch.cli.make_locomotion_dataset halfcheetah [--seed 0]
    python -m cleandiffuser_tpu_torch.cli.make_locomotion_dataset --all
    python -m cleandiffuser_tpu_torch.cli.make_locomotion_dataset halfcheetah \\
        --platform cpu --replay-only --max-steps 20000
"""

import argparse
import time
from pathlib import Path

import numpy as np

from ..pipelines.data_loading import D4RL_SCORE_RANGES, data_dir
from ..utils.sac import SAC, DeviceCollector, NumpyActor

GYM_IDS = {
    "halfcheetah": "HalfCheetah-v5",
    "hopper": "Hopper-v5",
    "walker2d": "Walker2d-v5",
}
# normalized-score gates for the policy snapshots: the d4rl datasets'
# measured behavior averages (medium-expert implies the expert halves),
# read on the stochastic policy's return, since the datasets are rolled out
# stochastically and the deterministic mean action overshoots the data's
# quality
MEDIUM_TARGET = {"halfcheetah": 0.405, "hopper": 0.446, "walker2d": 0.62}
EXPERT_TARGET = {"halfcheetah": 0.88, "hopper": 0.95, "walker2d": 1.00}


def _score_fn(env_prefix):
    lo, hi = D4RL_SCORE_RANGES[env_prefix]
    return lambda ret: (ret - lo) / (hi - lo)


def evaluate_mean(env_id, actor_params, episodes=5, seed=0, stochastic=False):
    """Mean return of the snapshot; `stochastic=True` samples actions as
    `rollout` does, so a gate measures the return of the data to be logged."""
    import gymnasium as gym

    pi = NumpyActor(actor_params)
    rng = np.random.default_rng(seed + 31) if stochastic else None
    env = gym.make(env_id)
    rets = []
    for ep in range(episodes):
        obs, _ = env.reset(seed=seed + ep)
        done, ret = False, 0.0
        while not done:
            act = pi(obs[None].astype(np.float32), rng)[0]
            obs, rew, term, trunc, _ = env.step(act)
            ret += float(rew)
            done = term or trunc
        rets.append(ret)
    env.close()
    return float(np.mean(rets))


def train_sac(env_prefix, seed=0, n_envs=128, max_steps=3_000_000, warmup=10_000,
              eval_every=25_000, out_dir=Path("dev/d4rl"), log_every=25_000,
              stop_at_medium=False, device=None):
    """Online SAC (ring and updates on `device`); returns
    (sac, medium_actor, expert_actor, medium_replay_export)."""
    import gymnasium as gym

    env_id = GYM_IDS[env_prefix]
    score = _score_fn(env_prefix)
    envs = gym.vector.SyncVectorEnv([lambda: gym.make(env_id) for _ in range(n_envs)])
    obs_dim = envs.single_observation_space.shape[0]
    act_dim = envs.single_action_space.shape[0]
    sac = SAC(obs_dim, act_dim, rng=seed, device=device)
    # medium-replay is the ring over the whole learning curve up to the
    # medium gate (d4rl's semantics); 2M rows, so the later stochastic gate
    # cannot evict the early curve
    col = DeviceCollector(sac, 2_000_000, n_envs)
    host_rng = np.random.default_rng(seed)
    env_ids = np.arange(n_envs, dtype=np.int32)

    obs, _ = envs.reset(seed=seed)
    medium_actor = expert_actor = None
    medium_replay = None
    calibrated = []  # (20-episode calibrated score, actor) past the gate
    t0, steps = time.time(), 0
    new = None

    def export_replay():
        # the pending batch enters the ring only at the top of the next
        # iteration: flush it, or the export loses the last n_envs rows
        nonlocal new
        if new is not None:
            col.step(obs.astype(np.float32), new, update=False)
            new = None
        return col.export()

    # gymnasium >= 1.0 NEXT_STEP autoreset: a done step returns the true
    # final obs; the following step is the reset (action ignored, reward
    # 0) and must not enter the replay
    prev_done = np.zeros((n_envs,), bool)
    while steps < max_steps:
        if steps < warmup:
            act = host_rng.uniform(-1, 1, (n_envs, act_dim)).astype(np.float32)
            if new is not None:
                col.step(obs.astype(np.float32), new, update=False)
        else:
            act, log = col.step(obs.astype(np.float32), new, update=True)
        nobs, rew, term, trunc, info = envs.step(act)
        valid = ~prev_done  # the rows after a done step are resets
        done = np.logical_or(term, trunc)
        # the bootstrap mask is the termination only (timeouts bootstrap
        # through); rows stay n_envs wide with a mask column
        new = {"obs": obs.astype(np.float32),
               "act": act.astype(np.float32),
               "rew": rew.astype(np.float32),
               "next_obs": nobs.astype(np.float32),
               "term": term.astype(np.float32),
               "done": done.astype(np.float32),
               "env": env_ids,
               "mask": valid.astype(np.float32)}
        prev_done = done
        obs = nobs
        steps += n_envs
        if steps % log_every < n_envs and steps >= warmup:
            sps = steps / max(time.time() - t0, 1e-9)
            print(f"[sac:{env_prefix}] {steps} steps ({sps:.0f}/s) "
                  f"q={float(log['q_mean']):.1f} alpha={float(log['alpha']):.3f}", flush=True)
        if steps % eval_every < n_envs and steps >= warmup:
            actor_now = sac.snapshot_actor()
            ret = evaluate_mean(env_id, actor_now, episodes=5, seed=seed + 100, stochastic=True)
            ns = score(ret)
            print(f"[sac:{env_prefix}] eval @ {steps}: return={ret:.0f} "
                  f"normalized(stoch)={ns:.3f}", flush=True)
            if medium_actor is None and ns >= MEDIUM_TARGET[env_prefix]:
                target = MEDIUM_TARGET[env_prefix]
                if medium_replay is None:
                    # medium-replay is the curve up to the first gate
                    # crossing, whichever snapshot the pick settles on
                    medium_replay = export_replay()
                    if steps > 2_000_000:
                        print(f"[sac:{env_prefix}] WARNING: medium gate crossed at {steps} > "
                              "ring capacity; the replay export lacks the earliest curve",
                              flush=True)
                # a 5-episode stochastic eval overestimates long-run
                # stability on fall-prone envs: calibrate with 20 episodes
                # and pick a snapshot only when that reaches the target
                ns_cal = score(evaluate_mean(env_id, actor_now, episodes=20, seed=seed + 200,
                                             stochastic=True))
                calibrated.append((ns_cal, actor_now))
                print(f"[sac:{env_prefix}] medium calibration @ {steps}: 5-ep {ns:.3f} -> "
                      f"20-ep {ns_cal:.3f} (target {target})", flush=True)
                if ns_cal >= target - 0.02:
                    medium_actor = actor_now
                    sac.save(str(out_dir / f"{env_prefix}_sac_medium.pkl"))
                    print(f"[sac:{env_prefix}] MEDIUM snapshot @ {steps} "
                          f"(calibrated {ns_cal:.3f})", flush=True)
                    if stop_at_medium:
                        break
            if ns >= EXPERT_TARGET[env_prefix]:
                expert_actor = actor_now
                sac.save(str(out_dir / f"{env_prefix}_sac_expert.pkl"))
                print(f"[sac:{env_prefix}] EXPERT snapshot @ {steps} (normalized {ns:.3f})",
                      flush=True)
                break
    envs.close()
    if medium_actor is None and calibrated:
        # past the gate but no calibrated pick reached the target (the expert
        # gate ended the loop first): the closest calibrated candidate
        ns_med, medium_actor = min(calibrated,
                                   key=lambda p: abs(p[0] - MEDIUM_TARGET[env_prefix]))
        sac.save(str(out_dir / f"{env_prefix}_sac_medium.pkl"))
        print(f"[sac:{env_prefix}] medium fallback pick: calibrated {ns_med:.3f}", flush=True)
    if medium_actor is None:  # the gate never crossed: the final policy
        medium_actor = sac.snapshot_actor()
        medium_replay = export_replay()
    if expert_actor is None:
        expert_actor = sac.snapshot_actor()
        print(f"[sac:{env_prefix}] WARNING: expert gate not reached by {max_steps} steps; "
              "using the final policy", flush=True)
    return sac, medium_actor, expert_actor, medium_replay


def rollout(env_prefix, actor_params, n_steps, seed=0, n_envs=16):
    """Log `n_steps` of the stochastic policy in the d4rl schema: a host
    loop of the numpy actor over a SyncVectorEnv."""
    import gymnasium as gym

    pi = NumpyActor(actor_params)
    rng = np.random.default_rng(seed + 7)
    env_id = GYM_IDS[env_prefix]
    envs = gym.vector.SyncVectorEnv([lambda: gym.make(env_id) for _ in range(n_envs)])
    obs, _ = envs.reset(seed=seed + 1000)
    O, A = envs.single_observation_space.shape[0], envs.single_action_space.shape[0]
    # NEXT_STEP autoreset: the reset rows are skipped (see train_sac). Rows
    # are collected per env and laid out env-major, so each env's stream
    # stays contiguous, as d4rl's episode-ordered streams are
    per = n_steps // n_envs
    cols = {k: np.zeros((n_envs, per) + s, np.float32) for k, s in
            (("observations", (O,)), ("actions", (A,)), ("rewards", ()),
             ("terminals", ()), ("timeouts", ()))}
    fill = np.zeros((n_envs,), np.int64)
    prev_done = np.zeros((n_envs,), bool)
    while fill.min() < per:
        act = pi(obs.astype(np.float32), rng)
        nobs, rew, term, trunc, _ = envs.step(act)
        valid = np.logical_and(~prev_done, fill < per)
        for i in np.nonzero(valid)[0]:
            j = fill[i]
            cols["observations"][i, j] = obs[i]
            cols["actions"][i, j] = act[i]
            cols["rewards"][i, j] = rew[i]
            cols["terminals"][i, j] = float(term[i])
            cols["timeouts"][i, j] = float(trunc[i])
            fill[i] += 1
        prev_done = np.logical_or(term, trunc)
        obs = nobs
    envs.close()
    data = {k: v.reshape((n_envs * per,) + v.shape[2:]) for k, v in cols.items()}
    # each env's last row ends its (possibly unfinished) episode
    for i in range(n_envs):
        row = (i + 1) * per - 1
        if data["terminals"][row] == 0:
            data["timeouts"][row] = 1.0
    return data


def to_qlearning(data):
    """The transition view (d4rl's qlearning_dataset) of an episode-
    contiguous stream: timeout rows are dropped (their successor is a
    reset), terminal rows kept (their next_observations slot is the next
    episode's first obs, which (1 - terminal) masks out of the TD target).
    Not for ring exports, whose rows interleave envs: those carry their own
    stored-successor view."""
    keep = ~(data["timeouts"][:-1] > 0)
    return {
        "observations": data["observations"][:-1][keep],
        "actions": data["actions"][:-1][keep],
        "next_observations": data["observations"][1:][keep],
        "rewards": data["rewards"][:-1][keep],
        "terminals": data["terminals"][:-1][keep],
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("envs", nargs="*", default=[])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-envs", type=int, default=128)
    ap.add_argument("--max-steps", type=int, default=3_000_000)
    ap.add_argument("--eval-every", type=int, default=25_000,
                    help="gate-eval cadence in env steps; tighten (e.g. 10000) for "
                         "fast-learning envs like hopper so the medium gate isn't overshot")
    ap.add_argument("--rollout-steps", type=int, default=1_000_000)
    ap.add_argument("--platform", default=None,
                    help="'cpu' runs the SAC updates on the CPU (default: the CUDA device)")
    ap.add_argument("--reuse-medium", action="store_true",
                    help="reuse a pre-existing <env>-medium-v2.npz instead of rolling a fresh "
                         "one (off by default: a stale file from another seed or run would "
                         "mix into medium-expert)")
    ap.add_argument("--replay-only", action="store_true",
                    help="stop after writing <env>-medium-replay-v2 (use --max-steps to "
                         "bound the SAC run)")
    ap.add_argument("--medium-only", action="store_true",
                    help="write medium-replay and the medium rollout, then skip the "
                         "expert and medium-expert stages (SAC stops at the calibrated "
                         "medium pick)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    envs = list(GYM_IDS) if args.all else args.envs
    if not envs:
        ap.error("pass env prefixes (halfcheetah/hopper/walker2d) or --all")
    out_dir = data_dir() if args.out is None else Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    def write(name, data, q=None):
        np.savez_compressed(out_dir / f"{name}.npz", **data)
        np.savez_compressed(out_dir / f"{name}.qlearning.npz",
                            **(q if q is not None else to_qlearning(data)))
        print(f"[data] wrote {name}: {data['rewards'].shape[0]} steps, "
              f"mean step reward {data['rewards'].mean():.3f}", flush=True)

    for env_prefix in envs:
        sac, medium, expert, med_replay = train_sac(
            env_prefix, seed=args.seed, n_envs=args.n_envs, max_steps=args.max_steps,
            out_dir=out_dir, eval_every=args.eval_every,
            stop_at_medium=args.replay_only or args.medium_only, device=args.platform)
        # the replay first: it is on the host already, and a consumer can
        # start before the rollouts end
        write(f"{env_prefix}-medium-replay-v2", med_replay, med_replay.pop("qlearning"))
        if args.replay_only:
            continue
        med_path = out_dir / f"{env_prefix}-medium-v2.npz"
        if args.reuse_medium and med_path.exists():
            print(f"[data:{env_prefix}] reusing existing {med_path} (--reuse-medium)",
                  flush=True)
            med_data = dict(np.load(med_path))
        else:
            print(f"[data:{env_prefix}] rolling out medium x{args.rollout_steps}", flush=True)
            med_data = rollout(env_prefix, medium, args.rollout_steps, seed=args.seed)
            write(f"{env_prefix}-medium-v2", med_data)
        if args.medium_only:
            continue
        print(f"[data:{env_prefix}] rolling out expert x{args.rollout_steps}", flush=True)
        exp_data = rollout(env_prefix, expert, args.rollout_steps, seed=args.seed + 1)
        me_data = {k: np.concatenate([med_data[k], exp_data[k]]) for k in med_data}
        write(f"{env_prefix}-medium-expert-v2", me_data)


if __name__ == "__main__":
    main()
