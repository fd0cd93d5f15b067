"""The staged consistency policy: the port's entry point (counterpart of
tutorials/sp_consistency_policy.py). IQL, then the EDM behavior policy,
then consistency distillation, then 2-NFE actions reselected by IQL's
advantage, at the tutorial's sizes on its synthetic data:

    python -m cleandiffuser_tpu_torch.cli.sp_consistency_policy
    python -m cleandiffuser_tpu_torch.cli.sp_consistency_policy platform=cpu hidden_dim=32

Runs on the CUDA device, and raises without one, unless given
`platform=cpu`; `hidden_dim=` sets the backbones' width (the tutorial's
pipeline default, 256). Everything else is the tutorial's: 3,000 synthetic
transitions in episodes of 200, the curriculum s0 6, s1 24 over 200 steps,
20 steps of each stage at batch 64, distillation over 12 levels, 16
candidates for 4 random observations at 2 steps. Batches come from the
dataset's device sampler with a generator seeded by `SEED`. Prints each
stage's last log and the actions; `main` returns them with the pipeline
and the dataset.
"""

import sys

import numpy as np
import torch
import yaml

from ..dataset import D4RLMuJoCoTDDataset, fake_d4rl_qlearning_dataset
from ..pipelines import ConsistencyPolicyPipeline
from ..utils.config import Config, parse_cli
from ..utils.tensors import default_device

# the tutorial's numbers
SEED, N_STEPS, EP_LEN, BATCH_SIZE, STAGE_STEPS, DISTILLATION_N = 0, 3000, 200, 64, 20, 12
NUM_ENVS, NUM_CANDIDATES, SAMPLING_STEPS = 4, 16, 2


def parse_args(argv) -> Config:
    args = Config(dict(platform=None, hidden_dim=256))
    for ov in parse_cli(argv):
        key, _, value = ov.partition("=")
        if key not in args:
            raise ValueError(f"unknown key {key!r}; the keys are {sorted(args)}")
        args[key] = yaml.safe_load(value)
    return args


def main(argv=()) -> dict:
    args = parse_args(argv)
    if args.platform not in (None, "cpu"):
        raise ValueError(f"unknown platform={args.platform!r} (null: the CUDA device; 'cpu')")
    device = default_device("cpu" if args.platform == "cpu" else None)
    ds = D4RLMuJoCoTDDataset(fake_d4rl_qlearning_dataset(n_steps=N_STEPS, ep_len=EP_LEN),
                             device=device)
    pipe = ConsistencyPolicyPipeline(obs_dim=ds.o_dim, act_dim=ds.a_dim,
                                     hidden_dim=args.hidden_dim, s0=6, s1=24,
                                     curriculum_cycle=200, rng=SEED, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    logs = {}

    def stage(name, step):
        print(f"== stage: {name} ==", flush=True)
        for _ in range(STAGE_STEPS):
            log = step(ds.sample_batch(gen, BATCH_SIZE))
        logs[name] = {k: float(v) for k, v in log.items()}
        print(logs[name], flush=True)

    stage("iql", pipe.iql_train_step)
    stage("edm", pipe.edm_train_step)
    pipe.prepare_distillation(distillation_N=DISTILLATION_N)
    stage("cd", pipe.cd_train_step)
    print(f"== inference: {SAMPLING_STEPS}-NFE actions with IQL reselection ==", flush=True)
    obs = np.random.default_rng(SEED).standard_normal((NUM_ENVS, ds.o_dim))
    act = pipe.act(obs.astype(np.float32), model="cd", num_candidates=NUM_CANDIDATES,
                   sampling_steps=SAMPLING_STEPS, generator=gen)
    print("actions:", act.cpu().numpy(), flush=True)
    return {"pipe": pipe, "dataset": ds, "logs": logs, "actions": act, "args": args}


if __name__ == "__main__":
    main(sys.argv[1:])
