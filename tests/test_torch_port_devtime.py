"""``igs_tpu_torch.utils.devtime.timeit_device`` against the contract of
``igs_tpu.utils.devtime.timeit_device``: (K+1)·(iters+1) calls, the same
float32 salt on the same leaf (the first floating leaf in
``jax.tree.flatten`` order), ValueError without a floating argument, and,
for the port, the same inputs for every repetition of a ``fn`` that
mutates or advances them. Salts are compared exactly."""

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from igs_tpu.utils import devtime as jax_devtime
from igs_tpu_torch.utils import devtime

torch.set_num_threads(2)


def test_port_calls_and_salts_match_jax():
    """The port's calls see x + salt·scale with salt r·(K+1)+j, the values
    JAX's jitted scan feeds ``fn`` (recorded through a debug callback)."""
    K, iters, scale = 2, 3, 1e-3
    jax_seen = []

    def jfn(x):
        jax.debug.callback(lambda v: jax_seen.append(np.asarray(v).copy()),
                           x)
        return x * 2

    jax_devtime.timeit_device(jfn, jnp.zeros(3), K=K, iters=iters,
                              salt_scale=scale)
    seen = []
    devtime.timeit_device(lambda x: seen.append(x.numpy().copy()),
                          torch.zeros(3), K=K, iters=iters, salt_scale=scale)
    assert len(seen) == len(jax_seen) == (K + 1) * (iters + 1)
    for got, want in zip(seen, sorted(jax_seen, key=lambda a: a[0])):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("salt,scale", [(0, 1e-9), (7, 1e-9), (33, 1e-6),
                                        (1e6, 3e-7)])
def test_salt_value_matches_jax(salt, scale):
    x = np.random.RandomState(0).normal(size=(4, 5)).astype(np.float32)
    want = jax_devtime._salt_args((jnp.asarray(x),), jnp.float32(salt),
                                  jnp.float32(scale))[0]
    got = devtime.salted_copy((torch.from_numpy(x),), salt, scale)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_first_floating_leaf_in_tree_order():
    """Dicts are visited in sorted key order, integers skipped, as
    ``jax.tree.flatten`` does; only that one leaf is salted."""
    ints = np.arange(3, dtype=np.int32)
    b = np.zeros(2, np.float32)
    a = np.full(2, 4.0, np.float32)
    want = jax_devtime._salt_args(
        ([jnp.asarray(ints)], {"b": jnp.asarray(b), "a": jnp.asarray(a)}),
        jnp.float32(3.0), jnp.float32(0.5))
    got = devtime.salted_copy(
        ([torch.from_numpy(ints)], {"b": torch.from_numpy(b),
                                    "a": torch.from_numpy(a)}), 3.0, 0.5)
    np.testing.assert_array_equal(got[0][0].numpy(), ints)
    for k in ("a", "b"):
        np.testing.assert_array_equal(got[1][k].numpy(),
                                      np.asarray(want[1][k]))
    assert list(got[1]) == ["b", "a"]  # the caller's key order is kept


@pytest.mark.parametrize("package", ["jax", "port"])
def test_no_floating_argument_raises(package):
    if package == "jax":
        with pytest.raises(ValueError):
            jax_devtime.timeit_device(lambda i: i * 2, jnp.arange(3), K=1,
                                      iters=1)
    else:
        calls = []
        with pytest.raises(ValueError):
            devtime.timeit_device(lambda i: calls.append(i),
                                  torch.arange(3), K=1, iters=1)
        assert calls == []  # raised before any call


@dataclass
class _State:
    x: torch.Tensor
    count: torch.Tensor
    gen: torch.Generator
    step: int


def test_mutating_fn_sees_the_same_inputs_every_repetition():
    """A fn that writes its tensors in place and advances a generator
    inside a dataclass starts every call from the caller's state, which
    stays untouched."""
    state = _State(x=torch.ones(4), count=torch.zeros(1, dtype=torch.int64),
                   gen=torch.Generator().manual_seed(3), step=5)
    x0 = state.x.clone()
    draws, counts, steps = [], [], []

    def fn(st):
        draws.append(torch.rand(2, generator=st.gen))
        counts.append(int(st.count))
        steps.append(st.step)
        st.x.mul_(3.0)
        st.count.add_(1)
        st.step += 1

    devtime.timeit_device(fn, state, K=3, iters=2)
    assert len(draws) == 4 * 3
    for d in draws[1:]:
        torch.testing.assert_close(d, draws[0], rtol=0, atol=0)
    assert counts == [0] * 12 and steps == [5] * 12
    assert torch.equal(state.x, x0) and int(state.count) == 0
    assert state.step == 5


def test_reducer_min_and_median():
    """Per-call seconds from the timed rounds only: min ≤ median."""
    import time

    def fn(x):
        time.sleep(0.002)

    lo = devtime.timeit_device(fn, torch.zeros(1), K=1, iters=3,
                               reducer="min")
    mid = devtime.timeit_device(fn, torch.zeros(1), K=1, iters=3)
    assert 0.002 <= lo <= mid + 1e-3
