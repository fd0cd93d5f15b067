"""The port's image Diffusion Policy and DiffusionBC pipelines against the
JAX package's, on the same seeded weights, observations and draws.

The images are 40 x 40, cropped to 36 (the GN-ResNet18 then ends at 2 x 2,
so its keypoints move with the image), with one rgb key and the agent's
position. The encoder runs at its fixed widths; the backbones narrow as in
test_torch_dp_dbc.py (a stand-in for the class in each package's pipeline
module): the Chi U-Net at model_dim 32, dim_mult (1, 2), the
PearceTransformer at trans_emb_dim 16, 4 heads; DP's DiT and the PearceMlp
at their shipped widths.

- Sampling with the JAX sampler's draws injected: DP chi_unet / dit x
  ddpm / edm, DBC pearce_mlp / pearce_transformer on ddpm, ddim, edm, with
  and without Diffusion-X steps. The float32 samples within 1e-5 absolute
  / 1e-4 relative, or, where float32 rounding alone is larger (the JAX
  sample more than 1e-5 from JAX's float64 run on the same draws), the
  port's distance from that run within twice the JAX sample's, and the
  port's own float64 run within 1e-9 of JAX's (test_torch_dp_dbc.py's
  rule). The encoder alone rounds ~8e-6 in float32 at these weights.
  The JAX engines' `init` is replaced by one that takes the param shapes
  from `jax.eval_shape` (every leaf is seeded anyway; this saves a compile
  of the encoder's init per pipeline).
- `evaluate_on_device` over 2 chunks (DP) and 3 env steps (DBC) from the
  JAX rollout's reset states with its sampler draws, on the image env
  rendering at 40: within 2 coverage points of 2,048 per env step.
- Training: without given offsets the crops come from the engine's
  generator; a window over the dataset's uint8 store. The training steps
  against JAX: test_torch_dp_dbc_image_train.py.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cleandiffuser_tpu.diffusion.basic as jbasic
import cleandiffuser_tpu.nn_condition.images as jimages
import cleandiffuser_tpu.pipelines.dbc_image as jdbc
import cleandiffuser_tpu.pipelines.dp_image as jdp
import cleandiffuser_tpu_torch.pipelines.dbc_image as tdbc
import cleandiffuser_tpu_torch.pipelines.dp_image as tdp
from cleandiffuser_tpu.dataset import PushTImageDataset as JaxPushTImage
from cleandiffuser_tpu.dataset import ReplayBuffer as JaxReplayBuffer
from cleandiffuser_tpu.env.pusht_jax import PushTImageEnvJax
from cleandiffuser_tpu.nn_diffusion import ChiUNet1d as JaxChiUNet
from cleandiffuser_tpu.nn_diffusion import PearceTransformer as JaxPearceTransformer
from cleandiffuser_tpu.utils import schedules as jax_schedules
from cleandiffuser_tpu.utils.train_state import TrainState
from cleandiffuser_tpu_torch.dataset import PushTImageDataset, generate_pusht_demos
from cleandiffuser_tpu_torch.env.pusht import PushTImageEnv
from cleandiffuser_tpu_torch.nn_condition.images import CROP_KEY
from cleandiffuser_tpu_torch.nn_diffusion import ChiUNet1d, PearceTransformer
from cleandiffuser_tpu_torch.utils import schedules as port_schedules
from cleandiffuser_tpu_torch.utils.jax_params import (
    _flatten_blocks,
    agent_params_of,
    load_agent_params,
)
from test_torch_dp_dbc import (
    ATOL,
    COV_STEP,
    F64_TOL,
    LR,
    RTOL,
    _close_adam_rule,
    _cosine_tables,
    _eval_draws,
    _f64,
    _jax_x64,
    _narrow,
    _reset_state,
    _sample_draws,
)
from test_torch_dql import _t
from test_torch_edm_cm import _close_tree, _jt

torch.set_num_threads(2)

ACT, H, TO, TA, B, IMG, CROP = 2, 8, 2, 4, 3, 40, 36
SHAPE_META = {"obs": {"image": {"shape": [3, IMG, IMG], "type": "rgb"},
                      "agent_pos": {"shape": [2], "type": "low_dim"}}}


def _shaped_init(self, x_example, condition_example=None):
    """A stand-in for the JAX engine's `init` (the tests seed every leaf
    anyway): the param tree's shapes from `jax.eval_shape`, which compiles
    nothing, filled with zeros; the keys split as `init` splits them."""
    x = jnp.asarray(x_example)
    cond = jax.tree_util.tree_map(jnp.asarray, condition_example)
    self._root_rng, kd, kc, ks = jax.random.split(self._root_rng, 4)

    def build(kd, kc):
        cp = self.nn_condition.init({"params": kc, "dropout": kc}, cond, train=False)
        emb = self.nn_condition.apply(cp, cond, train=False)
        dp = self.nn_diffusion.init({"params": kd, "dropout": kd}, x, self.t_example(x.shape[0]),
                                    emb, train=False)
        return {"diffusion": dp, "condition": cp}

    shapes = jax.eval_shape(build, kd, kc)
    params = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    self.state = TrainState.create(params, self.tx, ks)
    return self.state


class _JaxCrops:
    """A stand-in for the JAX module's `random_crop` that crops at the
    offsets queued in `queue` ((top, left) per call, in call order), read
    at run time through a host callback: one compiled update serves every
    step. The crop is exact either way (a one-hot product there)."""

    def __init__(self):
        self.queue = []

    def __call__(self, rng, img, ch, cw):
        *lead, h, w = img.shape
        b = img.shape[0]
        offs = jax.pure_callback(lambda: np.asarray(self.queue.pop(0), np.int32),
                                 jax.ShapeDtypeStruct((2, b), jnp.int32))
        flat = img.reshape(b, -1, h, w)
        rows = offs[0][:, None] + jnp.arange(ch)
        cols = offs[1][:, None] + jnp.arange(cw)
        out = flat[jnp.arange(b)[:, None, None, None], jnp.arange(flat.shape[1])[None, :, None, None],
                   rows[:, None, :, None], cols[:, None, None, :]]
        return out.reshape(tuple(lead) + (ch, cw))


JAX_CROPS = _JaxCrops()


@pytest.fixture(scope="module", autouse=True)
def small_backbones():
    mp = pytest.MonkeyPatch()
    mp.setattr(jdp, "ChiUNet1d", _narrow(JaxChiUNet, model_dim=32, emb_dim=32, dim_mult=(1, 2)))
    mp.setattr(tdp, "ChiUNet1d", _narrow(ChiUNet1d, model_dim=32, emb_dim=32, dim_mult=(1, 2)))
    mp.setattr(jdbc, "PearceTransformer", _narrow(JaxPearceTransformer, trans_emb_dim=16, nhead=4))
    mp.setattr(tdbc, "PearceTransformer", _narrow(PearceTransformer, trans_emb_dim=16, nhead=4))
    mp.setattr(jbasic.DiffusionModel, "init", _shaped_init)
    mp.setattr(jimages, "random_crop", JAX_CROPS)
    yield
    mp.undo()


def _cfg(kind, nn, diffusion, x_steps=0):
    common = dict(shape_meta=SHAPE_META, action_dim=ACT, obs_steps=TO, nn=nn,
                  diffusion=diffusion, crop_shape=(CROP, CROP), lr=LR, gradient_steps=10,
                  ema_rate=0.9)
    if kind == "dp":
        return dict(common, horizon=H, action_steps=TA, sample_steps=3, emb_dim=32)
    return dict(common, emb_dim=16, sample_steps=4, diffusion_x_sampling_steps=x_steps)


def _obs(seed, n=B, frames=TO, uint8=True):
    """A window of frames (channels-last uint8, the stores' layout) and
    agent positions."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, frames, IMG, IMG, 3), dtype=np.uint8)
    if not uint8:
        img = np.moveaxis(img, -1, -3).astype(np.float32) / 255.0
    return {"image": img, "agent_pos": rng.uniform(-1, 1, (n, frames, 2)).astype(np.float32)}


def _seeded(tree, seed):
    """Every leaf refilled with seeded normals: kernels at std
    1/sqrt(fan-in) in flax's layout (all axes but the last), norm scales
    1 + 0.1 N, other vectors 0.1 N."""
    rng = np.random.default_rng(seed)

    def fill(path, a):
        a = np.asarray(a)
        z = rng.standard_normal(a.shape)
        if a.ndim >= 2:
            return (z / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)
        scale = jax.tree_util.keystr(path).endswith("['scale']")
        return (z * 0.1 + (1.0 if scale else 0.0)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


_PAIRS = {}


def _pair(kind, nn, diffusion, x_steps=0):
    """A JAX pipeline and the port's with the same seeded params and EMA
    (built once per module, re-seeded at every call)."""
    key = (kind, nn, diffusion, x_steps)
    if key not in _PAIRS:
        J, P = ((jdp.DPImagePipeline, tdp.DPImagePipeline) if kind == "dp" else
                (jdbc.DBCImagePipeline, tdbc.DBCImagePipeline))
        cfg = _cfg(kind, nn, diffusion, x_steps)
        jp = J(**cfg)
        if kind == "dp":  # the JAX DP image pipeline builds its engine at the first batch
            jp.agent.init(jnp.zeros((1, H, ACT)),
                          jp._condition_of(jax.tree_util.tree_map(jnp.asarray, _obs(0, 1))))
        _PAIRS[key] = (jp, P(**cfg, device="cpu"))
    jp, tp = _PAIRS[key]
    st = jp.agent.state
    params, ema = _seeded(st.params, 1), _seeded(st.ema_params, 2)
    jp.agent.state = st.replace(params=_jt(params), ema_params=_jt(ema))
    load_agent_params(tp.agent.params, params)
    load_agent_params(tp.agent.ema_params, ema)
    return jp, tp


def _jax_f64_sample(jp, method, obs, key):
    """The JAX pipeline's sample in float64 on a float64 copy of its EMA
    weights and the float32 run's draws."""
    agent = jp.agent
    st, tables = agent.state, {k: getattr(agent, k) for k in ("alpha", "sigma")
                               if hasattr(agent, k)}
    jp._fn_cache.clear()
    try:
        with _jax_x64():
            agent.state = st.replace(ema_params=_f64(st.ema_params))
            if tables:
                agent.alpha, agent.sigma = _cosine_tables(jax_schedules, agent)
            out = getattr(jp, method)(jax.tree_util.tree_map(jnp.asarray, obs), key)
            assert out.dtype == np.float64
            return np.asarray(out)
    finally:
        agent.state = st
        for k, v in tables.items():
            setattr(agent, k, v)
        jp._fn_cache.clear()


def _f64_sample(tp, obs, noise):
    """The port's sampler in float64 on a float64 copy of its EMA weights."""
    agent = copy.deepcopy(tp.agent)
    agent.ema_params.double()
    agent.x_max, agent.x_min = (None if v is None else v.double()
                                for v in (tp.agent.x_max, tp.agent.x_min))
    d = lambda v: v.double() if isinstance(v, torch.Tensor) else tuple(u.double() for u in v)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "float32", torch.float64)
        mp.setattr(port_schedules, "_F32", torch.float64)
        if hasattr(agent, "alpha"):
            agent.alpha, agent.sigma = _cosine_tables(port_schedules, agent)
        cond = tp.condition_of(obs)
        B = cond["image"].shape[0]
        out, _ = agent.build_sample_fn(**tp.sample_kw)(
            agent.ema_params, None, torch.zeros(tp.prior_shape(B), dtype=torch.float64),
            condition_cfg=cond, w_cfg=1.0, noise=d(noise))
    return (tp.executed(out) if hasattr(tp, "executed") else out).numpy()


def _assert_sample_close(jp, tp, method, obs, key, noise, got, want):
    if np.allclose(got, want, atol=ATOL, rtol=RTOL):
        return
    ref64 = _jax_f64_sample(jp, method, obs, key)
    np.testing.assert_allclose(_f64_sample(tp, obs, noise), ref64, atol=F64_TOL, rtol=0)
    jax_err, port_err = np.abs(want - ref64).max(), np.abs(got - ref64).max()
    assert jax_err > ATOL and port_err <= 2 * jax_err, (np.abs(got - want).max(), jax_err,
                                                        port_err)


DP_CASES = [(nn, d) for nn in ("chi_unet", "dit") for d in ("ddpm", "edm")]
DBC_CASES = [("pearce_mlp", "ddpm", 0), ("pearce_mlp", "ddim", 2),
             ("pearce_transformer", "ddpm", 2), ("pearce_transformer", "edm", 0)]


@pytest.mark.parametrize("nn,diffusion", DP_CASES)
def test_dp_image_act_chunk_matches_jax(nn, diffusion):
    jp, tp = _pair("dp", nn, diffusion)
    obs, key = _obs(0), jax.random.PRNGKey(3)
    want = np.asarray(jp.act_chunk(jax.tree_util.tree_map(jnp.asarray, obs), key))
    noise = _sample_draws(tp, key, (B, H, ACT), 3)
    got = tp.act_chunk(obs, noise=noise).numpy()
    assert got.shape == (B, TA, ACT)
    _assert_sample_close(jp, tp, "act_chunk", obs, key, noise, got, want)
    # channels-first float frames in [0, 1] give the same condition
    same = tp.act_chunk(_obs(0, uint8=False), noise=noise).numpy()
    np.testing.assert_allclose(same, got, atol=1e-6, rtol=0)


@pytest.mark.parametrize("nn,diffusion,x_steps", DBC_CASES)
def test_dbc_image_act_matches_jax(nn, diffusion, x_steps):
    jp, tp = _pair("dbc", nn, diffusion, x_steps)
    obs, key = _obs(1), jax.random.PRNGKey(4)
    want = np.asarray(jp.act(jax.tree_util.tree_map(jnp.asarray, obs), key))
    noise = _sample_draws(tp, key, (B, ACT), 4 + x_steps)
    got = tp.act(obs, noise=noise).numpy()
    assert got.shape == (B, ACT)
    _assert_sample_close(jp, tp, "act", obs, key, noise, got, want)


def _batch(rng):
    obs = _obs(int(rng.integers(1 << 30)), frames=H)
    return {"obs": obs, "action": rng.uniform(-1, 1, (B, H, ACT)).astype(np.float32)}


def test_random_crops_come_from_the_generator():
    """Without given offsets the training crops are drawn from the engine's
    generator: the same seed gives the same step, another seed other crops
    (the other draws given)."""
    batch = _batch(np.random.default_rng(9))
    noise = (torch.tensor([1, 2, 3]), torch.randn(B, ACT, generator=torch.Generator()), None)
    losses = []
    for seed in (11, 11, 12):
        tp = tdbc.DBCImagePipeline(**_cfg("dbc", "pearce_mlp", "ddpm"), device="cpu")
        tp.agent.generator.manual_seed(seed)
        losses.append(float(tp.train_step(batch, noise=noise)["loss"]))
    assert losses[0] == losses[1] != losses[2]


# ---------------------------------------------------------------- evaluation
@pytest.fixture(scope="module")
def datasets():
    rb = generate_pusht_demos(n_episodes=2, max_steps=30, seed=0, with_images=True,
                              image_size=IMG)
    jrb = JaxReplayBuffer.create_from_data(dict(rb.data), rb.episode_ends)
    return (JaxPushTImage(jrb, horizon=H, pad_before=TO - 1, pad_after=TA - 1),
            PushTImageDataset(rb, horizon=H, pad_before=TO - 1, pad_after=TA - 1, device="cpu"))


@pytest.mark.parametrize("kind", ["dp", "dbc"])
def test_image_evaluate_on_device_matches_jax(datasets, kind):
    jds, tds = datasets
    n_envs, key = 3, jax.random.PRNGKey(8)
    if kind == "dp":
        jp, tp = _pair("dp", "chi_unet", "ddpm")
        steps, n_samples, shape, sample_steps = 2 * TA, 2, (n_envs, H, ACT), 3
    else:
        jp, tp = _pair("dbc", "pearce_mlp", "ddpm")
        steps, n_samples, shape, sample_steps = 3, 3, (n_envs, ACT), 4
    k_reset, draws = _eval_draws(key, n_samples, shape, sample_steps)
    want = jp.evaluate_on_device(PushTImageEnvJax(render_size=IMG), jds.normalizer,
                                 num_envs=n_envs, max_episode_steps=steps, rng=key)
    got = tp.evaluate_on_device(PushTImageEnv(render_size=IMG, device="cpu"), tds.normalizer,
                                num_envs=n_envs, max_episode_steps=steps,
                                reset_to_state=_reset_state(k_reset, n_envs), noise=draws)
    np.testing.assert_allclose(got[0], want[0], atol=steps * COV_STEP)
    np.testing.assert_allclose(got[1], want[1], atol=COV_STEP)


def test_training_window_runs_on_the_image_store(datasets):
    """`make_train_scan` over the dataset's uint8 store: finite window means."""
    _, tds = datasets
    _, tp = _pair("dp", "dit", "edm")
    log = tp.make_train_scan(tds, 4, 2)(torch.Generator().manual_seed(0))
    assert set(log) == {"loss", "grad_norm"} and all(np.isfinite(float(v)) for v in log.values())
