"""``igs_tpu_torch/graft_entry.py`` against the repo-root
``__graft_entry__.py``: ``entry()``'s forward on the CPU with the JAX
entry's ``model.init`` parameters carried across (``models/convert``)
against the JAX entry's own step, on the same tiny inputs (the same numpy
draws): images and depth within 1e-5 of each map's largest value (the
float32 reassociation of the JAX package's ``tiles`` oracle against the
port's, as in ``test_torch_port_agm.py``). Then ``dryrun_multichip(2)``
on two gloo ranks on the CPU: the JAX dry run's four lines, a finite
loss."""

import re

import jax
import numpy as np
import torch

import __graft_entry__ as jax_entry
from igs_tpu_torch import graft_entry

torch.set_num_threads(2)


def test_entry_matches_jax():
    jfn, jargs = jax_entry.entry()
    params = jax.tree.map(np.asarray, jargs[0])
    want = [np.asarray(x) for x in jax.jit(jfn)(*jargs)]
    fn, args = graft_entry.entry(device="cpu", flax_params=params)
    got = [x.numpy() for x in fn(*args)]
    assert [g.shape for g in got] == [w.shape for w in want] == [
        (1, 1, 3, 32, 32), (1, 1, 32, 32)]
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    # the inputs are the JAX entry's, draw for draw
    batch = args[1]
    for k, v in jargs[1].items():
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(v),
                                      err_msg=k)


def test_seeded_entry_runs():
    fn, args = graft_entry.entry(device="cpu")
    images, depth = fn(*args)
    assert images.shape == (1, 1, 3, 32, 32) and torch.isfinite(images).all()
    assert torch.isfinite(depth).all()


def test_dryrun_on_two_gloo_ranks(capsys):
    lines = graft_entry.dryrun_multichip(2, device="cpu", timeout_s=300)
    printed = capsys.readouterr().out
    assert len(lines) == 4 and all(line in printed for line in lines)
    m = re.fullmatch(r"dryrun_multichip OK: mesh=\{'data': 1, 'tile': 2\} "
                     r"loss=(\S+) psnr=(\S+)", lines[0])
    assert m and np.isfinite(float(m[1])) and np.isfinite(float(m[2]))
    assert lines[1].startswith("dryrun_multichip pallas-sharded OK: images (2,")
    assert lines[2] == ("dryrun_multichip sharded-refine OK: "
                        "mesh={'data': 1, 'tile': 2}")
    assert lines[3] == ("dryrun_multichip frame0-sweep OK: 2 frames over "
                        "mesh={'data': 2, 'tile': 1}")
