"""A stand-in for the JAX package's jitted parameter inits, for tests that
overwrite every parameter they read or whose checks do not read the
initial values.

`shaped_inits()` makes `DiffusionModel.init` and `BaseClassifier.init` of
the JAX package take the parameter shapes from `jax.eval_shape`, which
compiles nothing, fill them with zeros and build the train state from them
as the real inits do (optimizer state from `tx.init`, the keys split as
they split them). Building a pipeline then skips the compile of each net's
init, the largest cost of building a small one on the CPU.
"""

import contextlib

import jax
import jax.numpy as jnp
import pytest

import cleandiffuser_tpu.classifier.base as jclassifier
import cleandiffuser_tpu.diffusion.basic as jbasic


def _zeros(tree):
    return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), tree)


def _engine_init(self, x_example, condition_example=None):
    x = jnp.asarray(x_example)
    has_cond = condition_example is not None
    cond = jax.tree_util.tree_map(jnp.asarray, condition_example) if has_cond else None
    self._root_rng, kd, kc, ks = jax.random.split(self._root_rng, 4)

    def build(kd, kc):
        cp, emb = {}, None
        if has_cond:
            cp = self.nn_condition.init({"params": kc, "dropout": kc}, cond, train=False)
            emb = self.nn_condition.apply(cp, cond, train=False)
        dp = self.nn_diffusion.init({"params": kd, "dropout": kd}, x,
                                    self.t_example(x.shape[0]), emb, train=False)
        return {"diffusion": dp, "condition": cp}

    self.state = jbasic.TrainState.create(_zeros(jax.eval_shape(build, kd, kc)), self.tx, ks)
    return self.state


def _classifier_init(self, x_example, t_example, y_example=None):
    self._root_rng, k1, k2 = jax.random.split(self._root_rng, 3)
    args = jax.tree_util.tree_map(jnp.asarray, (x_example, t_example, y_example))
    shapes = jax.eval_shape(
        lambda k, x, t, y: self.nn_classifier.init({"params": k, "dropout": k}, x, t, y),
        k1, *args)
    self.state = jclassifier.TrainState.create(_zeros(shapes), self.tx, k2)
    return self.state


@contextlib.contextmanager
def shaped_inits():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbasic.DiffusionModel, "init", _engine_init)
        mp.setattr(jclassifier.BaseClassifier, "init", _classifier_init)
        yield
