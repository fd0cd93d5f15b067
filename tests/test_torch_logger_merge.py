"""`Logger.video_init` and `Config.merge` of the port against the JAX
package's (cleandiffuser_tpu/utils/logger.py:69-74, utils/config.py:75-81),
and the logger's rank-0 rule: on a mesh only rank 0 writes."""

import json

import pytest

from cleandiffuser_tpu.utils.config import Config as JaxConfig
from cleandiffuser_tpu.utils.logger import Logger as JaxLogger
from cleandiffuser_tpu_torch.env.wrapper import VideoRecordingWrapper
from cleandiffuser_tpu_torch.utils import logger as logger_mod
from cleandiffuser_tpu_torch.utils.config import Config


class _Env:
    """The least of an env the wrapper takes."""

    observation_space = action_space = None
    metadata = {}


class _NoRecorder:
    pass


@pytest.mark.parametrize("enable, video_id", [(True, "0"), (True, "ep3"), (False, "0")])
def test_video_init_matches_jax(tmp_path, enable, video_id):
    got, want = VideoRecordingWrapper(_Env()), VideoRecordingWrapper(_Env())
    logger_mod.Logger(tmp_path / "port").video_init(got, enable, video_id)
    JaxLogger(tmp_path / "port").video_init(want, enable, video_id)
    assert got.file_path == want.file_path
    assert (got.file_path is None) == (not enable)
    plain = _NoRecorder()
    logger_mod.Logger(tmp_path / "port").video_init(plain, enable, video_id)
    assert not hasattr(plain, "file_path")


def test_logger_writes_on_rank_zero_only(tmp_path, monkeypatch):
    monkeypatch.setattr(logger_mod, "is_writer", lambda: False)
    lg = logger_mod.Logger(tmp_path / "rank1", {"a": 1})
    lg.log({"loss": 1.0})
    env = VideoRecordingWrapper(_Env())
    lg.video_init(env, True)
    lg.finish()
    assert not (tmp_path / "rank1").exists() and env.file_path is None
    monkeypatch.setattr(logger_mod, "is_writer", lambda: True)
    lg = logger_mod.Logger(tmp_path / "rank0", {"a": 1})
    lg.log({"loss": 1.0})
    lg.finish()
    assert json.loads((tmp_path / "rank0/train.jsonl").read_text())["loss"] == 1.0


BASE = {"a": 1, "task": {"env_name": "hopper", "horizon": 32, "dims": {"obs": 11}},
        "lr": 2e-4, "tags": [1, 2]}
OTHERS = [
    {"a": 2, "task": {"horizon": 64, "dims": {"act": 3}}, "new": {"x": 1}},
    {"task": 5, "tags": [3]},
    {"lr": None, "task": {"dims": {"obs": 17}, "name": "walker"}},
]


@pytest.mark.parametrize("other", OTHERS)
@pytest.mark.parametrize("as_config", [False, True])
def test_config_merge_matches_jax(other, as_config):
    got, want = Config(BASE), JaxConfig(BASE)
    got.merge(Config(other) if as_config else other)
    want.merge(JaxConfig(other) if as_config else other)
    assert got.to_dict() == want.to_dict()
    # a merged-in Config is stored as plain data, then wrapped afresh
    assert isinstance(got.task, Config) == isinstance(want.task, JaxConfig)
