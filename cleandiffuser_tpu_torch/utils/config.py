"""Hydra-style configuration loader (counterpart of
cleandiffuser_tpu/utils/config.py), reading the same `configs/` tree.

    args = load_config("configs/dd/mujoco", "mujoco",
                       overrides=["task=hopper-medium-v2", "num_envs=10"])
    args.task.obs_dim, args.d_model, ...

- `defaults: [_self_, task: <name>]` resolves `task/<name>.yaml` into
  `args.task` (any group, not just task).
- CLI-style overrides: "a.b=3", "task=walker2d-medium-v2" (re-resolves the
  group file), "+new_key=1". Values are parsed with yaml.
- An override of a key the yaml lacks is applied with a warning, except for
  the keys `parallel/integrate.py` `setup_mesh` reads, which no config
  file needs to carry (`RUNTIME_KEYS`).
- `resolve_config_cli(dir, name, argv, nn_key="nn")`: the hydra-style CLI
  spelling the imitation CLIs take: `--config-path=<dir>` /
  `--config-dir=<dir>` (relative to the current directory),
  `--config-name=<name>`, and `nn=<backbone>`, which switches to the
  sibling directory `<dir>/../<backbone>/` (or `<nn_root>/<backbone>/`)
  when it holds the config.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import yaml

__all__ = ["Config", "load_config", "parse_cli", "resolve_config_cli", "RUNTIME_KEYS"]

# read by `setup_mesh` with a default: overrides of them add them silently
RUNTIME_KEYS = frozenset({"bf16_sampling", "bf16_training", "n_devices", "mesh_shape",
                          "platform"})


class Config:
    """Attribute-style nested dict (read/write), similar to OmegaConf."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_data", {})
        for k, v in (data or {}).items():
            self._data[k] = Config(v) if isinstance(v, dict) else v

    def __getattr__(self, k):
        try:
            return object.__getattribute__(self, "_data")[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self._data[k] = Config(v) if isinstance(v, dict) else v

    def __getitem__(self, k):
        return self._data[k]

    def __setitem__(self, k, v):
        self.__setattr__(k, v)

    def __contains__(self, k):
        return k in self._data

    def get(self, k, default=None):
        return self._data.get(k, default)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def to_dict(self) -> Dict[str, Any]:
        return {
            k: v.to_dict() if isinstance(v, Config) else v for k, v in self._data.items()
        }

    def merge(self, other: Union["Config", Dict]):
        """Merge `other`'s keys in place: a dict or Config value into a Config
        already there key by key, recursively; any other value replaces."""
        for k, v in other.items():
            if isinstance(v, (Config, dict)) and isinstance(self._data.get(k), Config):
                self._data[k].merge(v)
            else:
                self.__setattr__(k, v.to_dict() if isinstance(v, Config) else v)

    def __repr__(self):
        return f"Config({self.to_dict()})"


def _set_dotted(cfg: Config, dotted: str, value: Any, allow_new: bool = False):
    parts = dotted.split(".")
    cur = cfg
    is_new = False
    for p in parts[:-1]:
        if p not in cur:
            is_new = True
            cur[p] = {}
        elif not isinstance(cur.get(p), Config):
            cur[p] = {}
        cur = cur[p]
    is_new = is_new or parts[-1] not in cur
    if is_new and not allow_new:
        # warn loudly but apply: a silent no-op override (a mistyped key) is
        # the failure mode this guards against
        print(f"[config] WARNING: override {dotted!r} addresses no existing "
              f"config key — creating it (use '+{dotted}=...' to add keys "
              "intentionally)", flush=True)
    cur[parts[-1]] = value


def load_config(
    config_path: Union[str, Path],
    config_name: str,
    overrides: Optional[Sequence[str]] = None,
) -> Config:
    config_path = Path(config_path)
    with open(config_path / f"{config_name}.yaml") as f:
        raw = yaml.safe_load(f) or {}

    defaults = raw.pop("defaults", [])
    cfg = Config(raw)

    # resolve defaults groups (e.g. - task: halfcheetah-medium-v2)
    group_choices: Dict[str, str] = {}
    for entry in defaults:
        if isinstance(entry, dict):
            for group, choice in entry.items():
                group_choices[str(group)] = str(choice)

    # group overrides like "task=hopper-medium-v2" change the file choice
    plain_overrides: List[str] = []
    for ov in overrides or []:
        key, _, value = ov.partition("=")
        key = key.lstrip("+")
        if key in group_choices and "." not in key and "/" not in str(value):
            if (config_path / key / f"{value}.yaml").exists():
                group_choices[key] = value
                continue
            available = sorted(p.stem for p in (config_path / key).glob("*.yaml"))
            raise ValueError(
                f"Unknown {key} '{value}' for {config_path.name}; "
                f"available: {available}"
            )
        plain_overrides.append(ov)

    for group, choice in group_choices.items():
        with open(config_path / group / f"{choice}.yaml") as f:
            cfg[group] = yaml.safe_load(f) or {}

    for ov in plain_overrides:
        key, _, value = ov.partition("=")
        _set_dotted(cfg, key.lstrip("+"), yaml.safe_load(value),
                    allow_new=key.startswith("+") or key in RUNTIME_KEYS)
    return cfg


def parse_cli(argv: Sequence[str]) -> List[str]:
    """Filter argv down to key=value override tokens."""
    return [a for a in argv if "=" in a and not a.startswith("-")]


def resolve_config_cli(default_dir: Union[str, Path], default_name: str, argv: Sequence[str],
                       nn_key: Optional[str] = None,
                       nn_root: Optional[Union[str, Path]] = None) -> Config:
    """The config a CLI's argv names (module note): the directory and file
    from `--config-path` / `--config-name`, the backbone's directory for
    `<nn_key>=<backbone>` (a sibling of the config's, or under `nn_root`),
    the other `key=value` tokens as overrides."""
    cfg_dir, cfg_name, overrides = Path(default_dir), default_name, []
    for a in argv:
        if a.startswith(("--config-path=", "--config-dir=")):
            cfg_dir = Path(a.split("=", 1)[1])
        elif a.startswith("--config-name="):
            cfg_name = a.split("=", 1)[1].removesuffix(".yaml")
        elif "=" in a and not a.startswith("-"):
            overrides.append(a)
    if nn_key:
        nn = next((o.split("=", 1)[1] for o in overrides if o.startswith(f"{nn_key}=")), None)
        root = cfg_dir.parent if nn_root is None else Path(nn_root)
        if nn is not None and (root / nn / f"{cfg_name}.yaml").exists():
            cfg_dir = root / nn
    return load_config(cfg_dir, cfg_name, overrides)
